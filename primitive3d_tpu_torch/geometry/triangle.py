"""Batched triangle primitives; triangles are ``(..., 3, 3)`` [a, b, c] rows.

Counterpart of ``primitive3d_tpu/geometry/triangle.py``. Sums over the
three components, and the cross products of :func:`ray_intersect`, are
written out so that their order is fixed on every device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

MISS = torch.finfo(torch.float32).max


def dot3(u: Tensor, v: Tensor) -> Tensor:
    """u . v over the last axis of length 3, as (u0 v0 + u1 v1) + u2 v2."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def cross3(u: Tensor, v: Tensor) -> Tensor:
    """u x v over the last axis of length 3, each component written out
    (``torch.linalg.cross`` may contract to FMAs on one device and not on
    another)."""
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


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


def subdivide(tris: Tensor) -> Tensor:
    """Each triangle of (T, 3, 3) into four by its edge midpoints, (4T, 3,
    3). Child k of triangle p is 4p + k, so after n rounds ``i // 4**n`` is
    the triangle that child i came from (the rule of
    ``tools/stream_sweep.py``)."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
    return torch.stack([torch.stack([a, ab, ca], 1),
                        torch.stack([ab, b, bc], 1),
                        torch.stack([ca, bc, c], 1),
                        torch.stack([ab, bc, ca], 1)], 1).reshape(-1, 3, 3)


def ray_intersect(ro: Tensor, rd: Tensor, tris: Tensor) -> Tensor:
    """Ray-triangle intersection parameter t, or float32 max on a miss.

    The Möller-Trumbore variant of the JAX package: double-sided, a miss
    where u < 0, u > 1, v < 0, u + v > 1, t < 0 or the denominator is 0
    (rays parallel to the plane, degenerate triangles). Broadcasts ``ro``,
    ``rd`` (..., 3) against ``tris`` (..., 3, 3).
    """
    a = tris[..., 0, :]
    v1v0 = tris[..., 1, :] - a
    v2v0 = tris[..., 2, :] - a
    rov0 = ro - a
    n = cross3(v1v0, v2v0)
    q = cross3(rov0, rd)
    denom = dot3(rd, n)
    d = torch.reciprocal(torch.where(denom == 0, 1e-30, denom))
    u = d * -dot3(q, v2v0)
    v = d * dot3(q, v1v0)
    t = d * -dot3(n, rov0)
    miss = ((u < 0.0) | (u > 1.0) | (v < 0.0) | ((u + v) > 1.0) | (t < 0.0)
            | (denom == 0))
    return torch.where(miss, MISS, t)
