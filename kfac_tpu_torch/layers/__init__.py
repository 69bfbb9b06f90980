"""Layer registration, helpers and curvature capture."""
