"""Vectorised axis-aligned bounding boxes.

Counterpart of ``primitive3d_tpu/geometry/aabb.py``. Boxes are ``(..., 2,
3)`` tensors stacking [min, max]; every function broadcasts over leading
batch dimensions. NaN follows the JAX package: ``torch.minimum`` /
``torch.maximum`` and ``amin`` / ``amax`` propagate it as ``jnp.minimum``
and ``jnp.max`` do, so an axis-parallel ray whose origin lies on a box plane
(``0 * inf``) gets the JAX answer from :func:`ray_intersect`. Three-term sums
and cross products are written out (``triangle.dot3``, ``cross3``) so that
every device rounds them alike.
"""
from __future__ import annotations

import torch

from ..core.device import DeviceLike, resolve_device
from .triangle import cross3, dot3

Tensor = torch.Tensor

MISS = torch.finfo(torch.float32).max


def empty_box(shape=(), device: DeviceLike = "cuda") -> Tensor:
    """Boxes of ``shape`` that contain nothing: min +inf, max -inf."""
    dev = resolve_device(device)
    lo = torch.full((*shape, 3), float("inf"), device=dev)
    hi = torch.full((*shape, 3), float("-inf"), device=dev)
    return torch.stack([lo, hi], dim=-2)


def from_points(points: Tensor) -> Tensor:
    """Tight box over points (..., N, 3) -> (..., 2, 3)."""
    return torch.stack([points.amin(dim=-2), points.amax(dim=-2)], dim=-2)


def union(a: Tensor, b: Tensor) -> Tensor:
    """The smallest box covering a and b."""
    return torch.stack([torch.minimum(a[..., 0, :], b[..., 0, :]),
                        torch.maximum(a[..., 1, :], b[..., 1, :])], dim=-2)


def diag(box: Tensor) -> Tensor:
    return box[..., 1, :] - box[..., 0, :]


def inflate(box: Tensor, amount) -> Tensor:
    """Grow the box by ``amount`` on every side."""
    return torch.stack([box[..., 0, :] - amount, box[..., 1, :] + amount],
                       dim=-2)


def intersection(a: Tensor, b: Tensor) -> Tensor:
    """Box-box intersection; may be empty."""
    return torch.stack([torch.maximum(a[..., 0, :], b[..., 0, :]),
                        torch.minimum(a[..., 1, :], b[..., 1, :])], dim=-2)


def is_empty(box: Tensor) -> Tensor:
    return (box[..., 1, :] < box[..., 0, :]).any(dim=-1)


def intersects(a: Tensor, b: Tensor) -> Tensor:
    """Box-box overlap test."""
    return ~is_empty(intersection(a, b))


def relative_pos(box: Tensor, p: Tensor) -> Tensor:
    """(p - min) / diag."""
    return (p - box[..., 0, :]) / diag(box)


def center(box: Tensor) -> Tensor:
    return (box[..., 0, :] + box[..., 1, :]) * 0.5


def contains(box: Tensor, p: Tensor) -> Tensor:
    return ((p >= box[..., 0, :]) & (p <= box[..., 1, :])).all(dim=-1)


def distance_sq(box: Tensor, p: Tensor) -> Tensor:
    """Squared point-box distance."""
    d = torch.clamp(torch.maximum(box[..., 0, :] - p, p - box[..., 1, :]),
                    min=0.0)
    return dot3(d, d)


def signed_distance(box: Tensor, p: Tensor) -> Tensor:
    """SDF-style signed distance, the JAX package's formula: it measures
    from the box [min, min + diag] with |p - min| folding."""
    q = (p - box[..., 0, :]).abs() - diag(box)
    m = torch.clamp(q, min=0.0)
    outside = torch.sqrt(dot3(m, m))
    inside = torch.clamp(q.amax(dim=-1), max=0.0)
    return outside + inside


def ray_intersect(box: Tensor, ro: Tensor, rd: Tensor) -> Tensor:
    """Slab-method ray-AABB test -> (..., 2) (tmin, tmax), (MISS, MISS)
    when disjoint. Branch-free: per-axis entry and exit, intersected; a
    zero direction component divides to +-inf."""
    inv = 1.0 / rd
    t0 = (box[..., 0, :] - ro) * inv
    t1 = (box[..., 1, :] - ro) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    miss = tmin > tmax
    return torch.stack([torch.where(miss, MISS, tmin),
                        torch.where(miss, MISS, tmax)], dim=-1)


def _project_minmax(points: Tensor, axis_vec: Tensor):
    """Min and max of points (..., N, 3) projected on axis (..., 3)."""
    d = dot3(points, axis_vec[..., None, :])
    return d.amin(dim=-1), d.amax(dim=-1)


def intersects_triangle(box: Tensor, tris: Tensor) -> Tensor:
    """Separating-axis box-triangle overlap test: the 3 box normals, the
    triangle normal and the 9 edge x box-normal cross products. Broadcasts
    box (..., 2, 3) against tris (..., 3, 3)."""
    lo, hi = box[..., 0, :], box[..., 1, :]
    signs = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=tris.dtype, device=tris.device)
    corners = lo[..., None, :] * (1 - signs) + hi[..., None, :] * signs

    # box normals: interval test on the triangle's extent
    sep_box_axes = ((tris.amax(dim=-2) < lo)
                    | (tris.amin(dim=-2) > hi)).any(dim=-1)

    # triangle normal
    n = cross3(tris[..., 1, :] - tris[..., 0, :],
               tris[..., 2, :] - tris[..., 0, :])
    tri_off = dot3(n, tris[..., 0, :])
    bmin, bmax = _project_minmax(corners, n)
    sep_tri_normal = (bmax < tri_off) | (bmin > tri_off)

    # edge x box normal
    edges = torch.stack([tris[..., 0, :] - tris[..., 1, :],
                         tris[..., 0, :] - tris[..., 2, :],
                         tris[..., 1, :] - tris[..., 2, :]], dim=-2)
    eye = torch.eye(3, dtype=tris.dtype, device=tris.device)
    axes = cross3(edges[..., :, None, :], eye)  # (..., 3, 3, 3)
    bmin, bmax = _project_minmax(corners[..., None, None, :, :], axes)
    tmin, tmax = _project_minmax(tris[..., None, None, :, :], axes)
    sep_edges = ((bmax < tmin) | (bmin > tmax)).any(dim=-1).any(dim=-1)

    return ~(sep_box_axes | sep_tri_normal | sep_edges)
