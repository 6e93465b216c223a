"""Camera ray generation."""
