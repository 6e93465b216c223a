"""LBVH: a linear BVH built in parallel on the device (Karras 2012).

Counterpart of ``primitive3d_tpu/bvh/lbvh.py``, step for step, so that both
packages build the same tree from the same triangles:

  1. Morton codes of the triangle centroids inside the scene box, stably
     sorted (``jnp.argsort`` is stable).
  2. The Karras radix tree: each internal node's range and split found
     independently by fixed-trip searches over the common-prefix length of
     the codes, with the index as a tie-break so every key is unique.
  3. Internal-node boxes by a range min/max query over the sorted leaf
     boxes (a doubling sparse table).
  4. Preorder escape links for stackless traversal (``traverse.py``).

PyTorch has no count-leading-zeros, so :func:`clz32` counts them exactly on
int64 values by halving; Morton codes are int64 holding 30 bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import triangle as tri_ops
from .morton import morton3d

Tensor = torch.Tensor

DONE = 2 ** 30  # traversal-terminated sentinel pointer

# passes of the escape-link resolution: the deepest tree supported
MAX_DEPTH = 128


class LBVH(NamedTuple):
    """Struct-of-arrays binary BVH over T triangles (T - 1 internal nodes).

    A child >= 0 is an internal node, < 0 the leaf ``~child`` in Morton
    order (one triangle per leaf). ``escape`` / ``escape_leaf`` thread the
    tree in preorder: the next node after a subtree is skipped or finished;
    DONE ends the walk.
    """

    left: Tensor  # (I,) int32
    right: Tensor  # (I,) int32
    box_lo: Tensor  # (I, 3) float32 internal-node box min
    box_hi: Tensor  # (I, 3) float32 internal-node box max
    escape: Tensor  # (I,) int32 preorder skip link of an internal node
    escape_leaf: Tensor  # (T,) int32 preorder skip link of a leaf
    tris_sorted: Tensor  # (T, 3, 3) float32 triangles in Morton order
    prim_order: Tensor  # (T,) int32 leaf k -> original triangle index

    @property
    def num_triangles(self) -> int:
        return self.tris_sorted.shape[0]


def clz32(x: Tensor) -> Tensor:
    """Leading zeros of the low 32 bits of int64 ``x`` (32 for 0), exactly."""
    x = x & 0xFFFFFFFF
    zero = x == 0
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))
        n = n + small * s
        x = torch.where(small, x << s, x)
    return torch.where(zero, 32, n)


def _delta_fn(codes: Tensor):
    """Common-prefix length of keys i and j (the index breaks ties of
    equal codes); -1 where j is out of range."""
    T = codes.shape[0]

    def delta(i: Tensor, j: Tensor) -> Tensor:
        valid = (j >= 0) & (j <= T - 1)
        jc = j.clamp(0, T - 1)
        ci, cj = codes[i], codes[jc]
        d_code = clz32(ci ^ cj)
        d_idx = 32 + clz32(i ^ jc)
        return torch.where(valid, torch.where(ci == cj, d_idx, d_code), -1)

    return delta


def build_lbvh(tris: Tensor) -> LBVH:
    """Build an LBVH over triangles (T, 3, 3), T >= 2, on their device."""
    T = tris.shape[0]
    if T < 2:
        raise ValueError(f"an LBVH needs at least 2 triangles, got {T}")
    dev = tris.device
    cent = tri_ops.centroids(tris)
    codes = morton3d(cent, tris.amin(dim=(0, 1)), tris.amax(dim=(0, 1)))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    tris_sorted = tris[order]
    delta = _delta_fn(codes)
    i = torch.arange(T - 1, dtype=torch.int64, device=dev)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    dmin = delta(i, i - d)

    # upper bound of the range length: masked doubling, 32 trips
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > dmin, lmax * 2, lmax)

    # binary search of the other end j = i + l * d
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(32):
        probe = l + t
        l = torch.where((t >= 1) & (delta(i, i + probe * d) > dmin), probe, l)
        t = t // 2
    j = i + l * d

    # split position: do-while with t = ceil(t / 2), fixed trips
    dnode = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(33):
        t_half = (t + 1) >> 1
        add = ~done & (delta(i, i + (s + t_half) * d) > dnode)
        s = torch.where(add, s + t_half, s)
        done = done | (t_half <= 1)
        t = t_half
    gamma = i + s * d + torch.clamp(d, max=0)

    lo_r = torch.minimum(i, j)
    hi_r = torch.maximum(i, j)
    left = torch.where(lo_r == gamma, ~gamma, gamma)
    right = torch.where(hi_r == gamma + 1, ~(gamma + 1), gamma + 1)

    # internal-node boxes: sparse-table range min / max over leaf boxes
    leaf_lo = tris_sorted.amin(dim=1)
    leaf_hi = tris_sorted.amax(dim=1)
    K = max(1, (T - 1).bit_length())
    tbl_lo, tbl_hi = [leaf_lo], [leaf_hi]
    ar = torch.arange(T, device=dev)
    for k in range(1, K):
        nxt = (ar + (1 << (k - 1))).clamp(max=T - 1)
        tbl_lo.append(torch.minimum(tbl_lo[-1], tbl_lo[-1][nxt]))
        tbl_hi.append(torch.maximum(tbl_hi[-1], tbl_hi[-1][nxt]))
    tbl_lo = torch.stack(tbl_lo)  # (K, T, 3)
    tbl_hi = torch.stack(tbl_hi)
    k_q = (31 - clz32(hi_r - lo_r + 1)).clamp(0, K - 1)
    start2 = hi_r - (1 << k_q) + 1
    box_lo = torch.minimum(tbl_lo[k_q, lo_r], tbl_lo[k_q, start2])
    box_hi = torch.maximum(tbl_hi[k_q, lo_r], tbl_hi[k_q, start2])

    # preorder escape links: parent and side of every child, in internal-id
    # and leaf-id spaces (one dump slot past the end takes the other kind)
    I = T - 1
    parent_int = torch.zeros(I + 1, dtype=torch.int64, device=dev)
    isleft_int = torch.zeros(I + 1, dtype=torch.bool, device=dev)
    parent_leaf = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    isleft_leaf = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    for child, left_side in ((left, True), (right, False)):
        is_leaf = child < 0
        int_idx = torch.where(is_leaf, I, child)
        leaf_idx = torch.where(is_leaf, ~child, T)
        parent_int[int_idx] = i
        isleft_int[int_idx] = left_side
        parent_leaf[leaf_idx] = i
        isleft_leaf[leaf_idx] = left_side
    parent_int, isleft_int = parent_int[:I], isleft_int[:I]
    parent_leaf, isleft_leaf = parent_leaf[:T], isleft_leaf[:T]

    # esc(left child) = its right sibling, esc(right child) = esc(parent),
    # esc(root) = DONE: MAX_DEPTH passes, each moving values one level down
    sib = right[parent_int]
    esc = torch.where(isleft_int, sib, DONE)
    esc[0] = DONE
    for _ in range(MAX_DEPTH):
        esc = torch.where(isleft_int, sib, esc[parent_int])
        esc[0] = DONE
    escape_leaf = torch.where(isleft_leaf, right[parent_leaf],
                              esc[parent_leaf])

    i32 = torch.int32
    return LBVH(left.to(i32), right.to(i32), box_lo, box_hi, esc.to(i32),
                escape_leaf.to(i32), tris_sorted, order.to(i32))
