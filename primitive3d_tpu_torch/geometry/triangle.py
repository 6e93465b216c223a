"""Batched triangle primitives; triangles are ``(..., 3, 3)`` [a, b, c] rows.

The part of ``primitive3d_tpu/geometry/triangle.py`` that the cluster build
needs. Sums over the three components are written out so that their order
is fixed on every device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def dot3(u: Tensor, v: Tensor) -> Tensor:
    """u . v over the last axis of length 3, as (u0 v0 + u1 v1) + u2 v2."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def normals(tris: Tensor, normalize: bool = True) -> Tensor:
    """Geometric normals (b - a) x (c - a)."""
    a = tris[..., 0, :]
    n = torch.linalg.cross(tris[..., 1, :] - a, tris[..., 2, :] - a, dim=-1)
    if normalize:
        n = n / torch.clamp(torch.sqrt(dot3(n, n)), min=1e-30)[..., None]
    return n


def centroids(tris: Tensor) -> Tensor:
    """(a + b + c) / 3."""
    return (tris[..., 0, :] + tris[..., 1, :] + tris[..., 2, :]) / 3.0
