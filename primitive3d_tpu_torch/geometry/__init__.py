"""Batched triangle primitives."""
