"""Mesh file I/O."""
