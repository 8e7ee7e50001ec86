"""FM-family models."""
