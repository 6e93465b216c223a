"""Shared host pieces: grid bounds, configuration, device choice, timing, checks."""
