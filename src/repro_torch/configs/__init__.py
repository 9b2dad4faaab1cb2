"""Published model configurations (and their smoke-size cuts)."""
