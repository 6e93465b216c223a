"""All-pairs ray casting: Möller-Trumbore as a matrix product (PyTorch).

Counterpart of ``primitive3d_tpu/mxu_cast.py``, the ``"mxu"`` backend of
``pipeline.render_depth``. A ray is the 10-vector ``[d, o x d, o, 1]``; a
triangle is a (10, 5) matrix whose columns give the three Plücker side
products, the denominator d.n and the numerator (a - o).n. One fp32 matrix
product per chunk of triangles tests every ray against every triangle; a ray
hits where the three side products share a sign and t = num / den lies in
[0, best). The JAX package computes this outside any Pallas kernel, so here
it is plain ``torch.matmul``. The sign test depends on the low bits, so the
product must run in full fp32: with TF32 (``torch.backends.cuda.matmul.
allow_tf32``) it would not. Differentiable with respect to the triangle
matrix and the rays through autograd; O(R * T), for small meshes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .geometry.triangle import dot3

Tensor = torch.Tensor

MISS = torch.finfo(torch.float32).max


def ray_vectors(origins: Tensor, dirs: Tensor) -> Tensor:
    """Pack rays (R, 3), (R, 3) into Plücker 10-vectors (R, 10)."""
    m = torch.linalg.cross(origins, dirs, dim=-1)
    ones = torch.ones(origins.shape[:-1] + (1,), dtype=origins.dtype,
                      device=origins.device)
    return torch.cat([dirs, m, origins, ones], dim=-1)


def triangle_matrix(tris: Tensor) -> Tensor:
    """Pack triangles (T, 3, 3) into intersection matrices (T, 10, 5).

    Degenerate triangles (a repeated vertex or a zero normal, such as the
    point triangles of capacity-padded faces ``[0, 0, 0]``) get an exactly
    zero matrix: a cross product contracted into FMAs leaves a rounding
    residue on them, which the sign test would take for a hit.
    """
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    zeros3 = torch.zeros_like(a)
    zeros1 = zeros3[:, :1]

    def edge_col(p, q):
        return torch.cat([torch.linalg.cross(p, q, dim=-1), q - p, zeros3,
                          zeros1], dim=-1)  # (T, 10)

    cols = [
        edge_col(a, b),
        edge_col(b, c),
        edge_col(c, a),
        torch.cat([n, zeros3, zeros3, zeros1], dim=-1),
        torch.cat([zeros3, zeros3, -n, dot3(a, n)[:, None]], dim=-1),
    ]
    w = torch.stack(cols, dim=-1)  # (T, 10, 5)
    deg = ((a == b).all(-1) | (b == c).all(-1) | (c == a).all(-1)
           | (n == 0.0).all(-1))
    return torch.where(deg[:, None, None], torch.zeros_like(w), w)


def chunk_hits(rvec: Tensor, w_chunk: Tensor) -> Tensor:
    """Intersection t (MISS on a miss) of all rays with one triangle chunk.

    rvec (R, 10), w_chunk (Tc, 10, 5) -> t (R, Tc).
    """
    Tc = w_chunk.shape[0]
    S = torch.matmul(rvec, w_chunk.permute(1, 0, 2).reshape(10, Tc * 5))
    s0, s1, s2, den, num = S.reshape(rvec.shape[0], Tc, 5).unbind(-1)
    inside = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
              | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
    t = num / torch.where(den == 0, torch.full_like(den, 1e-30), den)
    ok = inside & (den != 0) & (t >= 0)
    return torch.where(ok, t, torch.full_like(t, MISS))


def cast_mxu(w: Tensor, origins: Tensor, dirs: Tensor, max_dist: float,
             chunk: int = 512) -> Tuple[Tensor, Tensor]:
    """Closest hit of every ray against every triangle, chunk by chunk.

    ``w`` (T, 10, 5) from :func:`triangle_matrix` (zero rows never hit).
    Returns (t, triangle index), with t = max_dist and index -1 on a miss;
    the first triangle wins a tie.
    """
    T = w.shape[0]
    R = origins.shape[0]
    pad = (-T) % chunk
    w_p = torch.cat([w, w.new_zeros((pad, 10, 5))]).reshape(-1, chunk, 10, 5)
    rvec = ray_vectors(origins, dirs)
    best_t = torch.full((R,), float(max_dist), dtype=torch.float32,
                        device=w.device)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=w.device)
    for k in range(w_p.shape[0]):
        t = chunk_hits(rvec, w_p[k])  # (R, chunk)
        i = torch.argmin(t, dim=-1)
        tmin = torch.gather(t, 1, i[:, None])[:, 0]
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_i = torch.where(upd, (k * chunk + i).to(torch.int32), best_i)
    return best_t, best_i
