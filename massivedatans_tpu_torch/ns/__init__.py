"""Nested-sampling engine, region geometry, queues and integrator."""
