"""Mesh canonicalisation for order-independent comparisons.

Counterpart of ``primitive3d_tpu/core/canonical.py`` (numpy only): two
meshes that differ only in vertex and face order, as marching cubes from
two implementations may, compare equal after canonicalisation: vertices
sorted lexicographically, faces re-indexed, rotated to smallest-vertex-first
(winding preserved), and sorted.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def canonicalize_mesh(
    vertices: np.ndarray, faces: np.ndarray, decimals: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (sorted_vertices, renumbered_sorted_faces).

    Vertices are rounded to ``decimals`` and lexicographically sorted; faces
    are renumbered accordingly, cyclically rotated so the smallest vertex id
    comes first (preserving winding), then row-sorted.
    """
    vertices = np.round(np.asarray(vertices, np.float64), decimals)
    faces = np.asarray(faces, np.int64)
    order = np.lexsort((vertices[:, 2], vertices[:, 1], vertices[:, 0]))
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    v_sorted = vertices[order]
    f = inv[faces] if faces.size else faces
    if f.size:
        roll = np.argmin(f, axis=1)
        f = np.stack([f[np.arange(len(f)), (roll + k) % 3] for k in range(3)],
                     axis=1)
        f = f[np.lexsort((f[:, 2], f[:, 1], f[:, 0]))]
    return v_sorted, f


def assert_meshes_equal(
    v_a: np.ndarray,
    f_a: np.ndarray,
    v_b: np.ndarray,
    f_b: np.ndarray,
    atol: float = 1e-4,
) -> None:
    """Assert two meshes are equal up to vertex/face ordering."""
    if v_a.shape != v_b.shape:
        raise AssertionError(f"vertex count {v_a.shape} vs {v_b.shape}")
    if f_a.shape != f_b.shape:
        raise AssertionError(f"face count {f_a.shape} vs {f_b.shape}")
    va, fa = canonicalize_mesh(v_a, f_a)
    vb, fb = canonicalize_mesh(v_b, f_b)
    np.testing.assert_allclose(va, vb, atol=atol)
    # identical canonical vertex order makes face ids comparable directly
    np.testing.assert_array_equal(fa, fb)
