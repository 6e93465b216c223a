"""Two-level cluster structure for the cluster ray caster.

Counterpart of ``primitive3d_tpu/bvh/clusters.py``: Morton-sorted (or
input-order) triangles grouped into fixed-size clusters, each with an AABB.

``MxuClusterBVH`` keeps the JAX structure's ``boxes``, ``prim_order`` and
finish rows, with the Plücker data in f32 in a layout chosen for the CUDA
kernel (``csrc/cluster_cast.cu``). The JAX package splits it into bf16
hi/lo halves for the TPU's matrix unit; the card needs no split.

``ClusterTree`` is a box tree over a ``ClusterBVH``'s clusters, 32
children to a node, which the scalar-tier kernels
(``csrc/cluster_scalar.cu``) walk one warp per ray. The JAX package has no
counterpart: its kernels walk the clusters in lock-step per block of rays.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..geometry import triangle as tri_ops
from .morton import morton3d

Tensor = torch.Tensor

CLUSTER_SIZE = 128
SUB_SIZE = 8  # triangles per sub-box (second culling level)
WROW = 24  # floats per triangle row of MxuClusterBVH.w (22 used + 2 pad)
TREE_WIDTH = 32  # children per node of ClusterTree: one per lane of a warp


class ClusterBVH(NamedTuple):
    boxes: Tensor  # (C, 6) float32: lo_xyz, hi_xyz per cluster
    sub_boxes: Tensor  # (C, cluster_size / SUB_SIZE, 6) second level
    tri_data: Tensor  # (C, cluster_size, 9) float32: a, e1 = b-a, e2 = c-a
    prim_order: Tensor  # (C * cluster_size,) int32; -1 for padding slots

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[0]


def build_clusters(tris: Tensor, cluster_size: int = CLUSTER_SIZE,
                   order: str = "morton") -> ClusterBVH:
    """Build the cluster structure from (T, 3, 3) triangles, T >= 1.

    ``order="morton"`` stably sorts triangles by centroid Morton code;
    ``order="identity"`` keeps the input order. Padding slots replicate the
    last triangle (so the tail cluster's box stays tight) and carry
    ``prim_order = -1``.
    """
    T = tris.shape[0]
    if T == 0:
        raise ValueError("cannot build clusters from an empty mesh")
    dev = tris.device
    pad = (-T) % cluster_size
    if order == "identity":
        ts = torch.cat([tris, tris[-1:].expand(pad, 3, 3)], dim=0)
        prim = torch.cat([torch.arange(T, dtype=torch.int32, device=dev),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
    elif order == "morton":
        cent = tri_ops.centroids(tris)
        lo = tris.amin(dim=(0, 1))
        hi = tris.amax(dim=(0, 1))
        sorder = torch.argsort(morton3d(cent, lo, hi), stable=True)
        order_p = torch.cat([sorder, sorder[-1:].expand(pad)])
        ts = tris[order_p]
        prim = torch.cat([sorder.to(torch.int32),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
    else:
        raise ValueError(f"unknown cluster order {order!r}")

    C = ts.shape[0] // cluster_size
    tc = ts.reshape(C, cluster_size, 3, 3)
    boxes = torch.cat([tc.reshape(C, -1, 3).amin(dim=1),
                       tc.reshape(C, -1, 3).amax(dim=1)], dim=-1)
    nsub = cluster_size // SUB_SIZE
    sc = tc.reshape(C, nsub, SUB_SIZE * 3, 3)
    sub_boxes = torch.cat([sc.amin(dim=2), sc.amax(dim=2)], dim=-1)
    a = tc[:, :, 0]
    tri_data = torch.cat([a, tc[:, :, 1] - a, tc[:, :, 2] - a], dim=-1)
    return ClusterBVH(boxes, sub_boxes, tri_data, prim)


class ClusterTree(NamedTuple):
    """An implicit TREE_WIDTH-wide box tree over a ``ClusterBVH``'s clusters
    in their index order: the scalar-tier kernels' walk
    (``csrc/cluster_scalar.cu``).

    Level 0 is the clusters; node i of level k + 1 holds nodes
    TREE_WIDTH i .. TREE_WIDTH i + TREE_WIDTH - 1 of level k, up to a
    single root. ``nodes[g]`` holds the child boxes of internal node g
    (level 1 first, the root last) in one row of TREE_WIDTH floats per
    bound, lo x, lo y, lo z, hi x, hi y, hi z, so that a warp's lanes load
    one child each; the slots past a ragged last node's children are boxes
    at +inf, which no slab test passes.
    """

    nodes: Tensor  # (N, 6, TREE_WIDTH) float32 child boxes, SoA
    sizes: Tuple[int, ...]  # nodes per level: C, ..., 1

    def offsets(self) -> Tuple[int, ...]:
        """First row of ``nodes`` of each level (level 0 has none: -1)."""
        off, n = [-1], 0
        for size in self.sizes[1:]:
            off.append(n)
            n += size
        return tuple(off)


def tree_sizes(C: int) -> Tuple[int, ...]:
    """Nodes per level of the :class:`ClusterTree` over C >= 1 clusters: C,
    then ceil(n / TREE_WIDTH) per level, one level above the clusters at
    least, up to a single root."""
    sizes = [C]
    while len(sizes) == 1 or sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // TREE_WIDTH))
    return tuple(sizes)


def build_cluster_tree(boxes: Tensor) -> ClusterTree:
    """The :class:`ClusterTree` over cluster boxes (C, 6), C >= 1.

    A parent box is the exact ``amin`` / ``amax`` of its children's, so its
    slab interval contains each child's in float too: a walk from the root
    keeps every cluster that a flat cull of the cluster boxes keeps.
    """
    if boxes.shape[0] == 0:
        raise ValueError("cannot build a tree over no clusters")
    sizes = tree_sizes(boxes.shape[0])
    inf = torch.tensor(float("inf"), dtype=boxes.dtype, device=boxes.device)
    level, blocks = boxes, []
    for n, m in zip(sizes[:-1], sizes[1:]):
        kids = torch.cat([level, inf.expand(m * TREE_WIDTH - n, 6)])
        kids = kids.view(m, TREE_WIDTH, 6)
        blocks.append(kids.transpose(1, 2))
        # the +inf slots leave amin alone; hi takes amax of the real ones
        real = (torch.arange(m * TREE_WIDTH, device=boxes.device)
                < n).view(m, TREE_WIDTH, 1)
        level = torch.cat([kids[..., :3].amin(dim=1),
                           torch.where(real, kids[..., 3:], -inf)
                           .amax(dim=1)], dim=-1)
    return ClusterTree(torch.cat(blocks).contiguous(), sizes)


class MxuClusterBVH(NamedTuple):
    """Cluster structure of the cluster cast kernels.

    ``w[c, j]`` is triangle slot j's row of 24 floats: the three Plücker
    edge columns ``[a x b, b - a]``, ``[b x c, c - b]``, ``[c x a, a - c]``
    (6 floats each), then ``[-n, a.n]`` and two zeros. Against a ray
    ``(d, m = o x d, o)`` the side products are ``s_e = u_e[:3].d +
    u_e[3:].m``, the hit numerator is ``num = -n.o + a.n``, and the
    denominator d.n is ``s0 + s1 + s2`` exactly (a x b + b x c + c x a = n),
    so the kernel needs no fourth product. Degenerate triangles have all-zero
    rows. ``fin[c, j]`` is the finish row ``[n, a.n, 1/|n|, fid, 0, 0]``;
    padding slots carry ``fid = -1``. ``sub_boxes[c, k]`` bounds slots
    ``k * S / K .. (k + 1) * S / K - 1``, K = max(1, S / SUB_SIZE): the
    stream kernel's second cull.
    """

    boxes: Tensor  # (C, 6) float32 cluster AABBs
    w: Tensor  # (C, S, 24) float32 Plücker rows
    prim_order: Tensor  # (C*S,) int32; -1 for padding slots
    fin: Tensor  # (C, S, 8) float32 finish rows
    sub_boxes: Tensor  # (C, max(1, S / SUB_SIZE), 6) float32

    @property
    def num_clusters(self) -> int:
        return self.boxes.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.w.shape[1]


def build_mxu_clusters(tris: Tensor, cluster_size: int = CLUSTER_SIZE,
                       order: str = "morton") -> MxuClusterBVH:
    """Build the cast kernels' cluster structure from (T, 3, 3) triangles."""
    base = build_clusters(tris, cluster_size=cluster_size, order=order)
    C, S = base.num_clusters, cluster_size
    td = base.tri_data
    a = td[..., 0:3]
    b = a + td[..., 3:6]
    c3 = a + td[..., 6:9]
    n = torch.linalg.cross(b - a, c3 - a, dim=-1)
    an = tri_ops.dot3(a, n)

    def edge(p, q):
        return [torch.linalg.cross(p, q, dim=-1), q - p]

    z2 = torch.zeros((C, S, 2), dtype=td.dtype, device=td.device)
    w = torch.cat([*edge(a, b), *edge(b, c3), *edge(c3, a), -n, an[..., None],
                   z2], dim=-1)  # (C, S, 24)
    # degenerate triangles (a repeated vertex or a zero normal) get exactly
    # zero rows: a cross product that contracts to an FMA leaves a rounding
    # residue on a point triangle, which would pass the sign test as a
    # spurious t = 0 hit
    deg = ((td[..., 3:6] == 0.0).all(dim=-1)
           | (td[..., 6:9] == 0.0).all(dim=-1)
           | (b == c3).all(dim=-1)
           | (n == 0.0).all(dim=-1))
    w = torch.where(deg[..., None], torch.zeros_like(w), w)

    inv = 1.0 / torch.clamp(torch.sqrt(tri_ops.dot3(n, n)), min=1e-30)
    fid = base.prim_order.reshape(C, S).to(torch.float32)
    fin = torch.cat([n, an[..., None], inv[..., None], fid[..., None], z2],
                    dim=-1)  # (C, S, 8)
    sub = base.sub_boxes if S >= SUB_SIZE else base.boxes[:, None]
    return MxuClusterBVH(base.boxes, w.contiguous(), base.prim_order,
                         fin.contiguous(), sub.contiguous())


def _put(x, dtype, dev: torch.device) -> Tensor:
    """A writable, contiguous copy of array ``x`` on ``dev``."""
    return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(dev)


def from_jax_cluster_bvh(boxes, sub_boxes, tri_data, prim_order,
                         device: DeviceLike = "cuda") -> ClusterBVH:
    """The port's ``ClusterBVH`` from the JAX package's fields (numpy
    arrays of the same layout), so one cluster structure can feed both
    scalar-broadcast casters."""
    dev = resolve_device(device)
    return ClusterBVH(_put(boxes, np.float32, dev),
                      _put(sub_boxes, np.float32, dev),
                      _put(tri_data, np.float32, dev),
                      _put(prim_order, np.int32, dev))


def from_jax_clusters(boxes, w2, prim_order, fin,
                      device: DeviceLike = "cuda") -> MxuClusterBVH:
    """The port's structure from the JAX package's ``MxuClusterBVH`` fields.

    ``boxes`` (C, 6), ``w2`` (C, 48, 4S) stacked ``[wh; wh; wl]`` bf16,
    ``prim_order`` (C*S,) and ``fin`` (C, 24, S) stacked ``[f1; f2; f3]``
    bf16, as numpy arrays. Sets ``w = f32(wh) + f32(wl)`` rearranged into
    the port's rows and ``fin = f1 + f2 + f3``, so one cluster structure can
    feed both casters. The JAX structure keeps no vertices, so every
    sub-box is its cluster's box.
    """
    dev = resolve_device(device)
    w2 = np.asarray(w2).astype(np.float32)
    C, S = w2.shape[0], w2.shape[2] // 4
    w = (w2[:, 0:16] + w2[:, 32:48]).reshape(C, 16, 4, S)
    rows = np.zeros((C, WROW, S), np.float32)
    for e in range(3):  # edge columns: ray components [d, m] = rows 0..5
        rows[:, 6 * e:6 * e + 6] = w[:, 0:6, e]
    rows[:, 18:22] = w[:, 6:10, 3]  # numerator column: [o, 1] = rows 6..9
    f = np.asarray(fin).astype(np.float32)
    fin8 = f[:, 0:8] + f[:, 8:16] + f[:, 16:24]  # (C, 8, S)
    bx = _put(boxes, np.float32, dev)
    nsub = max(1, S // SUB_SIZE)
    return MxuClusterBVH(bx, _put(rows.transpose(0, 2, 1), np.float32, dev),
                         _put(prim_order, np.int32, dev),
                         _put(fin8.transpose(0, 2, 1), np.float32, dev),
                         bx[:, None].expand(C, nsub, 6).contiguous())
