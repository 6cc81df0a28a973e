"""Problem layer: Gaussian line and analytic-evidence models."""
