"""Progress reporting."""
