"""Stackless threaded LBVH traversal, batch-vectorised (plain PyTorch).

Counterpart of ``primitive3d_tpu/bvh/traverse.py``: each ray's state is a
node pointer, its best t and its best leaf; one step tests the current
node's box (descend to the left child on a hit, else follow the escape
link) or the current leaf's triangle (then follow the leaf's escape link).
All rays step in lock-step until every pointer is DONE; finished rays do
nothing. The JAX package checks ``any(node != DONE)`` every step inside a
``while_loop``; here that check is a host sync, so it runs every
``CHECK_EVERY`` steps, and the extra steps are no-ops.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import triangle as tri_ops
from .lbvh import DONE, LBVH

Tensor = torch.Tensor

CHECK_EVERY = 16  # lock-step steps between host checks for the end


def cast_rays(bvh: LBVH, origins: Tensor, dirs: Tensor, max_dist: float
              ) -> Tuple[Tensor, Tensor]:
    """Closest hit of rays (R, 3): (depth, leaf index); leaf -1 on a miss."""
    R = origins.shape[0]
    dev = origins.device
    inv = torch.reciprocal(dirs)  # +-inf on zero components
    I = bvh.left.shape[0]
    left, escape = bvh.left.long(), bvh.escape.long()
    escape_leaf = bvh.escape_leaf.long()
    node = torch.zeros((R,), dtype=torch.int64, device=dev)  # the root
    best_t = torch.full((R,), float(max_dist), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=dev)
    while True:
        for _ in range(CHECK_EVERY):
            is_leaf = node < 0
            active = node != DONE
            # internal: box test
            n_int = torch.where(is_leaf, 0, node).clamp(0, I - 1)
            t0 = (bvh.box_lo[n_int] - origins) * inv
            t1 = (bvh.box_hi[n_int] - origins) * inv
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            tmin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
            tmax = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
            box_hit = (tmin <= tmax) & (tmax >= 0) & (tmin < best_t)
            # leaf: triangle test
            k = torch.where(is_leaf, ~node, 0)
            t_tri = tri_ops.ray_intersect(origins, dirs, bvh.tris_sorted[k])
            better = active & is_leaf & (t_tri < best_t)
            best_t = torch.where(better, t_tri, best_t)
            best_i = torch.where(better, k, best_i)
            # advance the pointer
            nxt = torch.where(is_leaf, escape_leaf[k],
                              torch.where(box_hit, left[n_int],
                                          escape[n_int]))
            node = torch.where(active, nxt, DONE)
        if not bool((node != DONE).any()):
            return best_t, best_i.to(torch.int32)
