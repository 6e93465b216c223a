"""Cluster ray caster: work-list prep, CUDA kernels ``csrc/cluster_cast.cu``
and their plain PyTorch version.

Counterpart of the cluster caster of
``primitive3d_tpu/kernels/raycast_kernel.py`` (``_ray_intervals``,
``_interval_cull``, ``_stream_entries``, ``_mxu_prep`` and
``cast_clusters_mxu``). Rays go in blocks of MBLOCK = 2048, each cut into
NCH = 8 chunks of RCHUNK = 256 rays. The prep culls every chunk's ray
interval against every cluster box and writes the same work lists as the
JAX package, through the cull kernel ``stream_cull``
(``csrc/stream_cull.cu``, plain version ``work_lists_plain``), which has no
Pallas counterpart: the JAX package builds the lists in plain XLA.

  * resident tier: per block, the flagged (cluster, chunk) pairs
    ``(c << 3) | r`` compacted to the front in cluster-major order;
  * stream tier: per block, one word ``(c << 16) | chunk_mask`` per flagged
    cluster, stably sorted front to back by its conservative entry bound,
    with the sorted bounds beside it.

Two kernels consume them, each with its wrapper and launch count:
``cluster_cast_resident`` and ``cluster_cast_stream``, one walk in
``csrc/cluster_cast.cu``: a warp per 32 rays walks its chunk's list on its
own, with a box and a sub-box cull per cluster, and for the stream list an
early exit per warp. A wrapper launches its kernel for CUDA tensors and
runs the plain version for CPU tensors (``cluster_cast_plain`` for both
casts, which visits every listed cluster); there is no fallback between
the two. ``cast_disputes`` settles the rays where the culls or the exit
are not exact against rounding noise.

Past STREAM_MAX_CLUSTERS clusters (the stream word's 15-bit cluster id)
the casters take the scalar tier, ``cast_clusters`` (the JAX function of
that name). The JAX kernels walk the clusters in lock-step for blocks of
1,024 rays; here one warp per ray walks a 32-wide box tree over the
clusters (``bvh.clusters.ClusterTree``), nearest child first with a
second cull over sub-boxes of 8 triangles, or in index order without it.
Its kernels are ``cluster_scalar_ordered`` and ``cluster_scalar``
(``csrc/cluster_scalar.cu``), with the plain version
``cluster_scalar_plain``.

The differentiable cast ``cast_clusters_diff`` (counterpart of the JAX
function of that name and its custom VJPs) finds hits with those kernels
and recomputes depth from the winners' planes. Its stream-tier backward is
a further kernel, ``plane_scatter`` (``csrc/plane_scatter.cu``, plain
version ``plane_scatter_plain``): over the forward's work list, it orders
the rays by winner once and sums each row in ray order.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..bvh.clusters import (SUB_SIZE, TREE_WIDTH, build_cluster_tree,
                            tree_sizes)
from ..geometry.triangle import dot3
from . import _build

Tensor = torch.Tensor

RCHUNK = 256  # rays per chunk (one CUDA block of the cast kernels)
MBLOCK = 2048  # rays per block of the work lists
NCH = MBLOCK // RCHUNK
WROW = 24  # floats per triangle row of MxuClusterBVH.w
MAX_CLUSTER_SIZE = 256
_CULL_ELEMS = 1 << 23  # (block, chunk, cluster) cells per cull pass
_PLAIN_VISITS = 128  # visits per batch of the plain cast (~0.3 GB of temps)
_I64_MAX = torch.iinfo(torch.int64).max
# the stream word packs (cluster_id << 16) | chunk mask in an int32: past
# this many clusters the casters take the scalar-broadcast tier
STREAM_MAX_CLUSTERS = 32767

# [work, bounds, n, stride, boxes, sub_boxes, widen, w, fin, rays, Rp, B, S,
#  max_dist, edge_wildcard, depth, idx, fin_out, visits]
_CAST_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
              + [ctypes.c_float] + [ctypes.c_void_p] * 3
              + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4)
RESIDENT = _build.Kernel(
    "cluster_cast_resident", "cluster_cast.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:604",
    argtypes=_CAST_ARGS)
STREAM = _build.Kernel(
    "cluster_cast_stream", "cluster_cast.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:372",
    argtypes=_CAST_ARGS)
STREAM_WALK = 32  # rays per independent walk of both cast kernels (a warp)
# the cast kernels' box cull widens each box by this share of |o|_1 + the
# box's largest coordinate (a launch argument of csrc/cluster_cast.cu)
CULL_WIDEN = 2.0 ** -14
# a float32 t that a float64 evaluation of the same test does not confirm
# to this share, or whose test fails in float64, is rounding noise
NOISE_REL = 2.0 ** -12
_DISPUTES_MAX = 4096  # differing rays cast_disputes examines at most


# --- prep: ray intervals, interval cull, work lists --------------------------

def _ray_intervals(o: Tensor, d: Tensor, B: int, nch: int = NCH,
                   rchunk: int = RCHUNK) -> Tensor:
    """Per-(block, chunk) ray intervals: origin box + clamped inverse
    direction bounds, [oxlo, oxhi, ..., ozhi, ivxlo, ..., ivzhi] ->
    (B, nch, 12). The 1/d clip to +-1e18 keeps 0 * inf NaNs out."""
    ob = o.reshape(B, nch, rchunk, 3)
    ivb = torch.clamp(1.0 / d.reshape(B, nch, rchunk, 3), -1e18, 1e18)
    oint = torch.stack([ob.amin(2), ob.amax(2)], dim=-1).reshape(B, nch, 6)
    ivint = torch.stack([ivb.amin(2), ivb.amax(2)], dim=-1).reshape(B, nch, 6)
    return torch.cat([oint, ivint], dim=-1)


def _interval_cull(boxes: Tensor, rint: Tensor, max_dist: float
                   ) -> Tuple[Tensor, Tensor]:
    """Conservative slab test of chunk ray intervals against cluster boxes.

    Returns ok (B, nch, C) and tl (B, nch, C): a lower bound on any chunk
    ray's box-entry time, the stream tier's front-to-back key. All 8
    endpoint products bound each ray's near/far crossing, so a flag is a
    superset of the exact per-ray flags.
    """
    tl = th = None
    for a in range(3):
        L0 = boxes[None, None, :, a]
        L1 = boxes[None, None, :, a + 3]
        olo = rint[:, :, 2 * a, None]
        ohi = rint[:, :, 2 * a + 1, None]
        ivl = rint[:, :, 6 + 2 * a, None]
        ivh = rint[:, :, 7 + 2 * a, None]
        d00, d01, d10, d11 = L0 - ohi, L0 - olo, L1 - ohi, L1 - olo
        prods = (d00 * ivl, d00 * ivh, d01 * ivl, d01 * ivh,
                 d10 * ivl, d10 * ivh, d11 * ivl, d11 * ivh)
        nr = fr = prods[0]
        for q in prods[1:]:
            nr = torch.minimum(nr, q)
            fr = torch.maximum(fr, q)
        tl = nr if tl is None else torch.maximum(tl, nr)
        th = fr if th is None else torch.minimum(th, fr)
    ok = (tl <= th) & (th >= 0.0) & (tl < max_dist)
    # max(tl, 0), a zero always +0.0: torch.clamp(-0.0, min=0) and amin
    # over -0.0 and +0.0 leave the sign of a zero to the implementation,
    # and the stream bounds are compared bit for bit across devices
    return ok, torch.where(tl > 0.0, tl, 0.0)


def _culled(boxes: Tensor, rint: Tensor, max_dist: float):
    """Yield (block slice, ok & non-degenerate (b, C, nch), tl (b, C, nch))
    over groups of blocks, bounding the cull's memory at flagship size."""
    B, nch = rint.shape[:2]
    C = boxes.shape[0]
    # zero-extent cluster boxes (point-triangle padding) are never hit
    nondeg = (boxes[:, 3:] > boxes[:, :3]).any(dim=-1)
    step = max(1, _CULL_ELEMS // max(1, nch * C))
    for s in range(0, B, step):
        ok, tl = _interval_cull(boxes, rint[s:s + step], max_dist)
        ok = ok & nondeg[None, None, :]
        yield slice(s, s + step), ok.transpose(1, 2), tl.transpose(1, 2)


def _stream_entries(boxes: Tensor, rint: Tensor, max_dist: float
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Stream work list: n (B,), entries (B, C) and bounds (B, C)."""
    B, nch = rint.shape[:2]
    C = boxes.shape[0]
    dev = boxes.device
    bits = 1 << torch.arange(nch, dtype=torch.int32, device=dev)
    cid = torch.arange(C, dtype=torch.int32, device=dev) << 16
    entries = torch.empty((B, C), dtype=torch.int32, device=dev)
    sbound = torch.empty((B, C), dtype=torch.float32, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    for blk, okc, tlc in _culled(boxes, rint, max_dist):
        cmask = (okc.to(torch.int32) * bits).sum(dim=-1, dtype=torch.int32)
        bound = torch.where(okc, tlc, 3.0e38).amin(dim=-1)  # (b, C)
        flagged = cmask > 0
        # front to back: flagged clusters first, by bound, stably
        key = torch.where(flagged, bound, float("inf"))
        perm = torch.sort(key, dim=1, stable=True).indices
        entries[blk] = torch.gather(cid[None, :] | cmask, 1, perm)
        sbound[blk] = torch.gather(bound, 1, perm)
        n[blk] = flagged.sum(dim=1, dtype=torch.int32)
    return n, entries, sbound


def _resident_pairs(boxes: Tensor, rint: Tensor, max_dist: float
                    ) -> Tuple[Tensor, Tensor]:
    """Resident work list: n (B,) and pairs (B, C*nch), cluster-major."""
    B, nch = rint.shape[:2]
    C = boxes.shape[0]
    dev = boxes.device
    pairs = torch.empty((B, C * nch), dtype=torch.int32, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    for blk, okc, _ in _culled(boxes, rint, max_dist):
        okt = okc.reshape(okc.shape[0], C * nch)
        # pair id c * nch + r == (c << 3) | r; flagged ones to the front
        perm = torch.sort((~okt).to(torch.int8), dim=1, stable=True).indices
        pairs[blk] = perm.to(torch.int32)
        n[blk] = okt.sum(dim=1, dtype=torch.int32)
    return n, pairs


def work_lists_plain(boxes: Tensor, rays: Tensor, max_dist: float,
                     stream: bool):
    """Plain version of the cull kernel: ``(n, work, bounds)`` of the
    rays ``rays`` (9, Rp) = [d; o x d; o] against the cluster boxes (C, 6),
    as :func:`work_lists` returns them."""
    B = rays.shape[1] // MBLOCK
    rint = _ray_intervals(rays[6:9].T, rays[0:3].T, B)
    if stream:
        return _stream_entries(boxes, rint, max_dist)
    n, pairs = _resident_pairs(boxes, rint, max_dist)
    return n, pairs, None


CULL = _build.Kernel(
    "stream_cull", "stream_cull.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:801,840,856,889",
    argtypes=[ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
def work_lists(boxes: Tensor, rays: Tensor, max_dist: float, stream: bool):
    """The cast kernels' work lists: ``(n, work, bounds)``.

    ``rays`` (9, Rp) float32 = [d; o x d; o] with Rp a multiple of MBLOCK,
    ``boxes`` (C, 6) float32. Per block of MBLOCK rays: ``n`` (B,) int32
    list lengths; stream tier, ``work`` (B, C) int32 words ``(c << 16) |
    chunk mask``, the flagged clusters sorted by their entry bound, ties in
    index order, then the rest in index order, and ``bounds`` (B, C)
    float32 beside them (3e38 past n); resident tier, ``work`` (B, 8 C)
    int32 pairs ``(c << 3) | chunk``, flagged ones first in cluster-major
    order, then the rest, and ``bounds`` None. Launches
    ``csrc/stream_cull.cu`` for CUDA tensors and runs
    :func:`work_lists_plain` for CPU tensors.
    """
    if rays.dim() != 2 or rays.shape[0] != 9 or rays.shape[1] % MBLOCK \
            or rays.shape[1] == 0 or rays.dtype != torch.float32:
        raise ValueError(f"rays must be (9, Rp) float32 with Rp a positive "
                         f"multiple of {MBLOCK}")
    if boxes.dim() != 2 or boxes.shape[1] != 6 or boxes.shape[0] < 1 \
            or boxes.dtype != torch.float32:
        raise ValueError("boxes must be (C, 6) float32 with C >= 1")
    if boxes.device != rays.device:
        raise ValueError("boxes and rays must be on one device")
    C = boxes.shape[0]
    if stream and C > STREAM_MAX_CLUSTERS:
        raise ValueError(f"stream tier supports at most "
                         f"{STREAM_MAX_CLUSTERS} clusters, got {C}")
    if rays.device.type == "cpu":
        return work_lists_plain(boxes, rays, max_dist, stream)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    if not (boxes.is_contiguous() and rays.is_contiguous()):
        raise ValueError("boxes and rays must be contiguous")
    Rp = rays.shape[1]
    B = Rp // MBLOCK
    dev = rays.device
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    work = torch.empty((B, C if stream else C * NCH), dtype=torch.int32,
                       device=dev)
    bounds = (torch.empty((B, C), dtype=torch.float32, device=dev)
              if stream else None)
    with torch.cuda.device(dev):
        CULL.launch(rays.data_ptr(), Rp, B, boxes.data_ptr(), C,
                    float(max_dist), int(bool(stream)), n.data_ptr(),
                    work.data_ptr(),
                    bounds.data_ptr() if stream else None)
    return n, work, bounds


def _ray_rows(o: Tensor, d: Tensor, Rp: int) -> Tensor:
    """The cast kernels' ray rows (9, Rp) = [d; o x d; o] of rays
    ``o``/``d`` (R, 3), padded to Rp with o = 0, d = 1, written in place."""
    R = o.shape[0]
    rays = torch.empty((9, Rp), dtype=torch.float32, device=o.device)
    rays[0:3, :R] = d.T
    rays[0:3, R:] = 1.0
    rays[6:9, :R] = o.T
    rays[6:9, R:] = 0.0
    torch.linalg.cross(rays[6:9], rays[0:3], dim=0, out=rays[3:6])
    return rays


def _mxu_prep(bvh, o: Tensor, d: Tensor, max_dist: float, stream: bool):
    """Work lists and ray rows for the cast kernels.

    ``o``/``d`` (R, 3) are padded to Rp, the next multiple of MBLOCK, with
    o = 0, d = 1. Returns ``(n, work, bounds, rays)``: the lists of
    :func:`work_lists` and the ray rows (9, Rp) = [d; o x d; o].
    """
    rays = _ray_rows(o, d, o.shape[0] + (-o.shape[0]) % MBLOCK)
    n, work, bounds = work_lists(bvh.boxes, rays, max_dist, stream)
    return n, work, bounds, rays


# --- the cast: plain version ------------------------------------------------

def _triangle_tests(W: Tensor, R: Tensor, edge_wildcard: bool
                    ) -> Tuple[Tensor, Tensor]:
    """(sign test passed, t), each (V, S, RCHUNK), of V visits in the
    dtype of W and R: W (V, S, 24) cluster rows, R (9, V, RCHUNK) ray rows.
    In float32 the arithmetic, in the same order, of csrc/cluster_cast.cu.
    """
    dx, dy, dz, mx, my, mz, ox, oy, oz = (R[k][:, None, :] for k in range(9))
    u = [W[..., k, None] for k in range(22)]  # (V, S, 1) each
    s0 = u[0] * dx + u[1] * dy + u[2] * dz + u[3] * mx + u[4] * my + u[5] * mz
    s1 = (u[6] * dx + u[7] * dy + u[8] * dz + u[9] * mx + u[10] * my
          + u[11] * mz)
    s2 = (u[12] * dx + u[13] * dy + u[14] * dz + u[15] * mx + u[16] * my
          + u[17] * mz)
    num = u[18] * ox + u[19] * oy + u[20] * oz + u[21]
    bits = torch.int32 if s0.dtype == torch.float32 else torch.int64
    b0, b1, b2, b3 = (x.view(bits) for x in (s0, s1, s2, num))
    if edge_wildcard:
        nz = [x != 0.0 for x in (s0, s1, s2, num)]
        bs = (b0, b1, b2, b3)
        bad = torch.zeros_like(nz[0])
        for i in range(4):
            for j in range(i + 1, 4):
                bad |= ((bs[i] ^ bs[j]) < 0) & nz[i] & nz[j]
        ok = ~bad
    else:
        ok = ((b0 ^ b1) | (b0 ^ b2) | (b0 ^ b3)) >= 0
    return ok, num / ((s0 + s1) + s2)


def _visit_keys(W: Tensor, R: Tensor, edge_wildcard: bool) -> Tensor:
    """Packed min keys (V, RCHUNK) of V visits (see :func:`_triangle_tests`)."""
    S = W.shape[1]
    im = S - 1
    ok, t = _triangle_tests(W, R, edge_wildcard)
    tm = torch.abs(torch.where(ok, t, 3.0e38))
    slot = torch.arange(S, dtype=torch.int32, device=W.device)[:, None]
    return ((tm.view(torch.int32) & ~im) | slot).amin(dim=1)


def cluster_cast_plain(n: Tensor, work: Tensor, bounds: Optional[Tensor],
                       w: Tensor, fin: Tensor, rays: Tensor, max_dist: float,
                       edge_wildcard: bool = False, with_fin: bool = True):
    """Plain version of both cast kernels: a vectorised pass over all visits.

    ``bounds`` is None for the resident tier (pairs) and the stream bounds
    for the stream tier (entries). Per visit the packed min over the S
    triangles comes first; then, per ray, the smallest quantised t below
    max_dist wins, the first visit in list order on equal t (an int64 key
    ``t_bits << 32 | entry << 8 | slot`` and an amin). This version visits
    every listed cluster. The kernels skip clusters by their culls (and the
    stream kernel by its early exit), which drop no hit whose t lies inside
    its own box (``tests/test_torch_stream.py``); a sliver triangle's t,
    whose side-product sum is rounding noise, can lie far outside it, and on
    such a ray a kernel may keep a farther hit than this version.
    """
    stream = bounds is not None
    dev = rays.device
    B, L = work.shape
    Rp = rays.shape[1]
    S = w.shape[1]
    im = S - 1
    valid = torch.arange(L, device=dev)[None, :] < n.to(torch.int64)[:, None]
    vb, ve = valid.nonzero(as_tuple=True)
    words = work[vb, ve]
    if stream:
        bits = (words[:, None] >> torch.arange(NCH, device=dev)) & 1
        vi, vr = bits.nonzero(as_tuple=True)
        vb, ve, vc = vb[vi], ve[vi], words[vi] >> 16
    else:
        vr, vc = words & (NCH - 1), words >> 3
    lane = torch.arange(RCHUNK, device=dev)
    best = torch.full((Rp,), _I64_MAX, dtype=torch.int64, device=dev)
    for s in range(0, vb.numel(), _PLAIN_VISITS):
        sl = slice(s, s + _PLAIN_VISITS)
        ray_ids = (vb[sl] * MBLOCK + vr[sl] * RCHUNK)[:, None] + lane
        kmin = _visit_keys(w[vc[sl].to(torch.int64)], rays[:, ray_ids],
                           edge_wildcard)
        tb_bits = kmin & ~im
        key = ((tb_bits.to(torch.int64) << 32) | (ve[sl][:, None] << 8)
               | (kmin & im).to(torch.int64))
        key = torch.where(tb_bits.view(torch.float32) < max_dist, key,
                          _I64_MAX)
        best.scatter_reduce_(0, ray_ids.reshape(-1), key.reshape(-1), "amin")
    found = best != _I64_MAX
    tb = (best >> 32).to(torch.int32).view(torch.float32)
    e = (best >> 8) & 0xFFFFFF
    blocks = torch.arange(Rp, device=dev) // MBLOCK
    word = work[blocks, torch.where(found, e, 0)]
    c = (word >> 16) if stream else (word >> 3)
    depth = torch.where(found, tb, torch.full_like(tb, max_dist))
    idx = torch.where(found, c * S + (best & im).to(torch.int32), -1)
    if not with_fin:
        return depth, idx, None
    finr = fin.reshape(-1, 8)[idx.clamp(min=0).to(torch.int64)]
    return depth, idx, torch.where(found[:, None], finr,
                                   torch.zeros_like(finr))


# --- the cast: kernel wrappers -----------------------------------------------

def _stream_box_enters(boxes: Tensor, o: Tensor, d: Tensor) -> Tensor:
    """The cast kernels' box and sub-box cull in plain PyTorch, in their
    order of operations: does the ray ``o``/``d`` (..., 3) enter the box
    ``boxes`` (..., 6), widened by 2^-14 of (|o|_1 + the box's largest
    coordinate), ahead of its origin? All broadcast together -> (...) bool.
    A NaN slab is the whole line. The plain cast does not use it; the tests
    hold each ray's winning cluster and sub-box to it, which is what lets
    the kernel skip the others."""
    span = (o[..., 0].abs() + o[..., 1].abs()) + o[..., 2].abs()
    tol = (span + boxes.abs().amax(dim=-1)) * CULL_WIDEN
    inv = torch.reciprocal(d)
    return _slab([boxes[..., a] - tol for a in range(3)],
                 [boxes[..., a + 3] + tol for a in range(3)],
                 [o[..., a] for a in range(3)],
                 [inv[..., a] for a in range(3)])[1]


def _witness(W: Tensor, R: Tensor, edge_wildcard: bool, max_dist: float
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The float32 tests of cluster rows W (V, S, 24) against ray rows R
    (9, V, k), as :func:`_triangle_tests`, and a float64 witness of each
    -> (quantised t, hit: t < max_dist, noise), each (V, S, k). A hit is
    noise when its test fails in float64 on the same rows, or its float64
    t differs from its float32 t by more than NOISE_REL."""
    S = W.shape[1]
    ok, t = _triangle_tests(W, R, edge_wildcard)
    tm = torch.abs(torch.where(ok, t, 3.0e38))
    tq = (tm.view(torch.int32) & ~(S - 1)).view(torch.float32)
    ok64, t64 = _triangle_tests(W.double(), R.double(), edge_wildcard)
    t64 = t64.abs()
    hit = tq < max_dist
    noise = hit & ~(ok64 & ((t64 - tm.double()).abs() <= NOISE_REL * t64))
    return tq, hit, noise


def _listed_clusters(n: Tensor, work: Tensor, stream: bool, b: int,
                     r: int) -> Tensor:
    """The clusters listed for chunk ``r`` of block ``b``, in list order:
    stream words ``(c << 16) | chunk mask`` or resident pairs ``(c << 3) |
    r`` -> (Lq,) int64."""
    row = work[b, :int(n[b])]
    if stream:
        return (row[((row >> r) & 1).bool()] >> 16).to(torch.int64)
    return (row[(row & (NCH - 1)) == r] >> 3).to(torch.int64)


def cast_disputes(n: Tensor, work: Tensor, stream: bool, w: Tensor,
                  rays: Tensor, max_dist: float, edge_wildcard: bool, got,
                  want):
    """The rays on which a cast ``got`` = (depth, idx, ...) differs from
    the plain version's ``want``, each settled or not by a float64 witness
    -> (rays (Q,) int64, settled (Q,) bool, clean t (Q,)). ``(n, work)`` is
    the cast's list: stream words if ``stream``, else resident pairs.

    A cast kernel visits a subset of the listed clusters (its culls, and
    the stream kernel's early exit), so it may keep a farther hit than the
    plain version only where the plain version's winner lies outside its
    own box or in front of it. A ray is settled when (1) the plain t <= the
    kernel's t <= the clean t, the nearest float32 hit over the ray's
    listed clusters that is not noise; (2) the plain version's winning test
    is noise (:func:`_witness`); (3) the kernel's (t, idx) is the float32
    test of that ray with that triangle, and its cluster is listed (or a
    miss). Past _DISPUTES_MAX differing rays none is settled: that is no
    rounding matter.
    """
    dev = rays.device
    S = w.shape[1]
    dk, ik = got[0], got[1]
    dp, ip = want[0], want[1]
    bad = ((dk.view(torch.int32) != dp.view(torch.int32)) | (ik != ip))
    qs = bad.nonzero()[:, 0]
    settled = torch.zeros(qs.shape[0], dtype=torch.bool, device=dev)
    clean = torch.full((qs.shape[0],), float(max_dist), device=dev)
    if qs.shape[0] > _DISPUTES_MAX:
        return qs, settled, clean
    for j, q in enumerate(qs.tolist()):
        c = _listed_clusters(n, work, stream, q // MBLOCK,
                             (q % MBLOCK) // RCHUNK)
        tq, hit, noise = (x[..., 0] for x in _witness(
            w[c], rays[:, q].reshape(9, 1, 1), edge_wildcard, max_dist))
        real = hit & ~noise  # (Lq, S)
        if bool(real.any()):
            clean[j] = tq[real].min()
        tp, tk = float(dp[q]), float(dk[q])
        ck, cp = int(ik[q]) // S, int(ip[q]) // S
        if int(ip[q]) < 0 or not bool((c == cp).any()):
            continue
        p_noise = bool(noise[(c == cp).nonzero()[0, 0], int(ip[q]) % S])
        if int(ik[q]) < 0:
            k_ok = tk == float(max_dist)
        else:
            at = (c == ck).nonzero()
            k_ok = (at.shape[0] > 0 and tq[at[0, 0], int(ik[q]) % S]
                    .view(torch.int32) == dk[q].view(torch.int32))
        settled[j] = (tp <= tk <= float(clean[j])) and p_noise and bool(k_ok)
    return qs, settled, clean


def _check_cast_inputs(n, work, bounds, w, fin, rays, boxes, sub_boxes):
    if w.dim() != 3 or w.shape[2] != WROW or w.dtype != torch.float32:
        raise ValueError(f"w must be (C, S, {WROW}) float32, got "
                         f"{w.dtype} {tuple(w.shape)}")
    C, S = w.shape[:2]
    if S > MAX_CLUSTER_SIZE or S & (S - 1):
        raise ValueError(f"cluster size must be a power of two <= "
                         f"{MAX_CLUSTER_SIZE}, got {S}")
    if tuple(fin.shape) != (C, S, 8) or fin.dtype != torch.float32:
        raise ValueError(f"fin must be ({C}, {S}, 8) float32")
    if rays.dim() != 2 or rays.shape[0] != 9 or rays.shape[1] % MBLOCK:
        raise ValueError(f"rays must be (9, Rp) with Rp % {MBLOCK} == 0")
    B = rays.shape[1] // MBLOCK
    if work.dim() != 2 or work.shape[0] != B or work.dtype != torch.int32:
        raise ValueError(f"work list must be ({B}, L) int32")
    if tuple(n.shape) != (B,) or n.dtype != torch.int32:
        raise ValueError(f"n must be ({B},) int32")
    if bounds is not None and (bounds.shape != work.shape
                               or bounds.dtype != torch.float32):
        raise ValueError("bounds must match the entries, float32")
    if tuple(boxes.shape) != (C, 6) or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be ({C}, 6) float32")
    nsub = max(1, S // SUB_SIZE)
    if (tuple(sub_boxes.shape) != (C, nsub, 6)
            or sub_boxes.dtype != torch.float32):
        raise ValueError(f"sub_boxes must be ({C}, {nsub}, 6) float32")
    for t in (n, work, bounds, w, fin, rays, boxes, sub_boxes):
        if t is None:
            continue
        if t.device != rays.device:
            raise ValueError("all cast inputs must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("cast inputs must be contiguous and 16-byte "
                             "aligned")


def _cast(kernel, n, work, bounds, boxes, sub_boxes, w, fin, rays,
          max_dist, edge_wildcard, with_fin, visits):
    _check_cast_inputs(n, work, bounds, w, fin, rays, boxes, sub_boxes)
    if rays.device.type == "cpu":
        return cluster_cast_plain(n, work, bounds, w, fin, rays, max_dist,
                                  edge_wildcard, with_fin)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    Rp = rays.shape[1]
    B = Rp // MBLOCK
    dev = rays.device
    depth = torch.empty((Rp,), dtype=torch.float32, device=dev)
    idx = torch.empty((Rp,), dtype=torch.int32, device=dev)
    finr = (torch.empty((Rp, 8), dtype=torch.float32, device=dev)
            if with_fin else None)
    vshape = (B * NCH, 3)
    if visits is not None and (tuple(visits.shape) != vshape
                               or visits.dtype != torch.int32
                               or visits.device != dev):
        raise ValueError(f"visits must be {vshape} int32 on {dev}")
    with torch.cuda.device(dev):
        kernel.launch(
            work.data_ptr(), bounds.data_ptr() if bounds is not None
            else None, n.data_ptr(), work.shape[1], boxes.data_ptr(),
            sub_boxes.data_ptr(), CULL_WIDEN, w.data_ptr(),
            fin.data_ptr(), rays.data_ptr(), Rp, B, w.shape[1],
            float(max_dist), int(bool(edge_wildcard)), depth.data_ptr(),
            idx.data_ptr(), finr.data_ptr() if with_fin else None,
            visits.data_ptr() if visits is not None else None)
    return depth, idx, finr


def cluster_cast_resident(n: Tensor, pairs: Tensor, w: Tensor, fin: Tensor,
                          rays: Tensor, max_dist: float,
                          edge_wildcard: bool = False, with_fin: bool = True,
                          visits: Optional[Tensor] = None, *, boxes: Tensor,
                          sub_boxes: Tensor):
    """Resident-tier cast: (depth (Rp,), sorted idx (Rp,), fin rows (Rp, 8)).

    ``boxes`` (C, 6) and ``sub_boxes`` (C, max(1, S / SUB_SIZE), 6) are the
    cluster boxes and sub-boxes, which the kernel's per-warp culls read (the
    plain version visits every listed pair). ``visits`` (B * NCH, 3) int32,
    if given, zeroed, receives per chunk, summed over its walks of
    STREAM_WALK rays, the pairs they reached, the clusters and the
    sub-boxes they tested (kernel only)."""
    return _cast(RESIDENT, n, pairs, None, boxes, sub_boxes, w, fin, rays,
                 max_dist, edge_wildcard, with_fin, visits)


def cluster_cast_stream(n: Tensor, entries: Tensor, bounds: Tensor,
                        w: Tensor, fin: Tensor, rays: Tensor, max_dist: float,
                        edge_wildcard: bool = False, with_fin: bool = True,
                        visits: Optional[Tensor] = None, *, boxes: Tensor,
                        sub_boxes: Tensor):
    """Stream-tier cast, the outputs and the keyword arguments of
    :func:`cluster_cast_resident`; the walks also stop at their early exit,
    so ``visits`` counts the list entries they reached before it."""
    return _cast(STREAM, n, entries, bounds, boxes, sub_boxes, w, fin, rays,
                 max_dist, edge_wildcard, with_fin, visits)


def _cast_with_list(bvh, origins: Tensor, dirs: Tensor, max_dist: float,
                    stream: bool, with_fin: bool, edge_wildcard: bool):
    """Prep and cast: (depth, idx, fin rows) of the R rays and the work list
    ``(n, work)`` of the rays padded to a multiple of MBLOCK with o = 0,
    d = 1 (the backward scatter walks the same list)."""
    if stream and bvh.num_clusters > STREAM_MAX_CLUSTERS:
        raise ValueError(
            f"stream tier supports at most {STREAM_MAX_CLUSTERS} clusters, "
            f"got {bvh.num_clusters}; raise cluster_size")
    R = origins.shape[0]
    n, work, bounds, rays = _mxu_prep(bvh, origins, dirs, float(max_dist),
                                      stream)
    cull = dict(boxes=bvh.boxes, sub_boxes=bvh.sub_boxes)
    if stream:
        depth, idx, finr = cluster_cast_stream(
            n, work, bounds, bvh.w, bvh.fin, rays, max_dist, edge_wildcard,
            with_fin, **cull)
    else:
        depth, idx, finr = cluster_cast_resident(
            n, work, bvh.w, bvh.fin, rays, max_dist, edge_wildcard, with_fin,
            **cull)
    return (depth[:R], idx[:R], finr[:R] if with_fin else None), (n, work)


def cast_clusters_mxu(bvh, origins: Tensor, dirs: Tensor,
                      max_dist: float = 10.0, stream: bool = False,
                      with_fin: bool = False, edge_wildcard: bool = False):
    """Closest hit through the cluster kernels: (t, sorted-triangle index)
    and, with ``with_fin``, each ray's winning finish row (R, 8).

    ``bvh`` is a :class:`~primitive3d_tpu_torch.bvh.clusters.MxuClusterBVH`
    on the rays' device. Depth is quantised to 2^-17 relative (the packed
    slot bits); the caller refines winners from their plane. Rays are padded
    to a multiple of MBLOCK with o = 0, d = 1.
    """
    (depth, idx, finr), _ = _cast_with_list(bvh, origins, dirs, max_dist,
                                            stream, with_fin, edge_wildcard)
    return (depth, idx, finr) if with_fin else (depth, idx)


# --- scalar tier: meshes past STREAM_MAX_CLUSTERS clusters -------------------

# the JAX kernels' walk: rays in blocks of RAY_BLOCK, clusters in groups of
# GROUP, ordered per block by _order_and_bounds
RAY_BLOCK = 1024
GROUP = 32
_SCALAR_CELLS = 1 << 22  # (pair, box) or (pair, triangle) cells per pass
_INT32_MAX = torch.iinfo(torch.int32).max

# [tri, rays, R, C, S, max_dist, depth, idx, counts]
_SCALAR_ARGS = [ctypes.c_void_p] * 2 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p] * 3
SCALAR_ORDERED = _build.Kernel(
    "cluster_scalar_ordered", "cluster_scalar.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:45",
    argtypes=[ctypes.c_void_p] * 2 + _SCALAR_ARGS)
SCALAR = _build.Kernel(
    "cluster_scalar", "cluster_scalar.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:219",
    argtypes=[ctypes.c_void_p] + _SCALAR_ARGS)


def _block_mean(x: Tensor) -> Tensor:
    """Mean of (B, n, 3) over n, a power of two, by pairwise halving: the
    same sums in the same order on every device."""
    n = x.shape[1]
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0] / n


def _order_and_bounds(bvh, o: Tensor, B: int) -> Tuple[Tensor, Tensor]:
    """Per-ray-block front-to-back cluster order (B, C) int32 and the entry
    bound of each group of GROUP (B, G) float32: the prep of the JAX
    kernels' block walk, kept with its parity test. No path of the port
    calls it: its kernels walk a :class:`ClusterTree` per ray.

    A unit-direction ray travels at least the point-box distance from its
    block's mean origin, less the block's origin spread, before it enters a
    box; groups take the bound of their first (nearest) cluster. ``o`` is
    (B * RAY_BLOCK, 3), padded as the cast pads it. The sort is stable, as
    ``jnp.argsort`` is.
    """
    ob = o.reshape(B, RAY_BLOCK, 3)
    mo = _block_mean(ob)
    off = ob - mo[:, None]
    spread = torch.sqrt(dot3(off, off)).amax(dim=1)
    m = mo[:, None]
    gap = torch.clamp(torch.maximum(bvh.boxes[None, :, :3] - m,
                                    m - bvh.boxes[None, :, 3:]), min=0.0)
    bound = torch.clamp(torch.sqrt(dot3(gap, gap)) - spread[:, None],
                        min=0.0)
    order = torch.argsort(bound, dim=1, stable=True)
    sb = torch.gather(bound, 1, order)
    C = bound.shape[1]
    pad = (-C) % GROUP
    sb = torch.cat([sb, sb.new_full((B, pad), float("inf"))], dim=1)
    return order.to(torch.int32).contiguous(), sb[:, ::GROUP].contiguous()


def _slab(lo, hi, o, inv) -> Tuple[Tensor, Tensor]:
    """Slab test of boxes against rays, all broadcast together: ``lo``,
    ``hi``, ``o`` and ``inv`` (1 / d) are lists of the three axes' tensors.
    Returns (entry t, the ray meets the box ahead of its origin). The
    arithmetic of csrc/cluster_scalar.cu. A NaN is 0 * inf: a ray parallel
    to an axis whose origin lies on one of the box's planes there, inside
    the closed slab for every t."""
    tmin = tmax = None
    for a in range(3):
        t0 = (lo[a] - o[a]) * inv[a]
        t1 = (hi[a] - o[a]) * inv[a]
        on = torch.isnan(t0) | torch.isnan(t1)
        near = torch.where(on, -float("inf"), torch.minimum(t0, t1))
        far = torch.where(on, float("inf"), torch.maximum(t0, t1))
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    return tmin, (tmin <= tmax) & (tmax >= 0.0)


def _slab_useful(bx: Tensor, o, inv, best: Tensor) -> Tensor:
    """Slab test of boxes ``bx`` (n, k, 6) against rays, ``o``/``inv``
    three (n, 1, r) rows each: does each ray enter each box at t < ``best``
    (n, 1, r)? -> (n, k, r) bool."""
    tmin, ok = _slab([bx[..., a, None] for a in range(3)],
                     [bx[..., a + 3, None] for a in range(3)], o, inv)
    return ok & (tmin < best)


def _triangle_t(tri: Tensor, o, d) -> Tensor:
    """Möller-Trumbore t of rays (``o``/``d`` three rows each, broadcast as
    (n, 1, r)) against triangle rows ``tri`` (n, k, 9) = [a, e1, e2] -> (n,
    k, r), inf where the test fails. The arithmetic of
    csrc/cluster_scalar.cu, in the JAX kernel's order."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (tri[..., q, None]
                                                 for q in range(9))
    ox, oy, oz = o
    dx, dy, dz = d
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    f = torch.reciprocal(torch.where(det == 0.0, 1e-30, det))
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return torch.where(ok, t, float("inf"))


def _take(best: Tensor, bidx: Tensor, ray: Tensor, t: Tensor,
          tid: Tensor) -> None:
    """Update each ray's best hit (best, bidx) (R,) in place with the
    candidates (ray, t, tid), t < max_dist, each triangle at most once per
    ray: the smallest t wins, a tie the smallest index (the kernels' rule
    ``t < best or t == best and id < bidx``); the winner keeps its own t
    bits."""
    R = best.shape[0]
    tmin = best.new_full((R,), float("inf")).scatter_reduce(
        0, ray, t, "amin")
    tie = t == tmin[ray]
    imin = torch.full((R,), _INT32_MAX, dtype=torch.int64,
                      device=best.device).scatter_reduce(
        0, ray[tie], tid[tie], "amin")
    win = tie & (tid == imin[ray])
    tw = best.new_full((R,), float("inf"))
    tw[ray[win]] = t[win]
    upd = (tw < best) | ((tw == best) & (imin < bidx))
    best.copy_(torch.where(upd, tw, best))
    bidx.copy_(torch.where(upd, imin.to(torch.int32), bidx))


def cluster_scalar_plain(tree, bvh, rays: Tensor, max_dist: float,
                         ordered: bool = True,
                         counts: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Plain version of both scalar-tier kernels: (depth (R,), sorted idx
    (R,)).

    The function the kernels compute, walked level by level as a frontier
    of (ray, node) pairs: from the root of ``tree`` (a
    :class:`~primitive3d_tpu_torch.bvh.clusters.ClusterTree` over ``bvh``'s
    clusters) down to the clusters, a pair's children are those whose box
    the ray enters at t < max_dist; at a cluster the ordered walk keeps the
    sub-boxes the ray enters so and tests their 8 triangles each, the
    unordered one tests all S. Each ray gets its nearest hit t < max_dist,
    a tie going to the smallest sorted index. This walk culls against
    max_dist alone, where the kernels also prune by the ray's best hit, so
    it is the walk without pruning: ``counts`` (R, 4) int32, if given,
    receives each ray's internal nodes entered, child boxes tested,
    sub-boxes tested and triangles tested in it, the most the kernels' own
    counts can be. Rays are independent: any set of the columns of ``rays``
    gives those rays' results.
    """
    dev = rays.device
    R = rays.shape[1]
    C, S = bvh.tri_data.shape[:2]
    md = float(max_dist)
    o, inv = rays[:3], torch.reciprocal(rays[3:])
    off = tree.offsets()
    tally = torch.zeros((4, R), dtype=torch.int64, device=dev)
    ray = torch.arange(R, device=dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)

    def frontier(boxes, width, ray, node):
        """The (ray, node * width + j) pairs whose child j's box, from
        ``boxes(node)`` (p, 6, width), the ray enters at t < max_dist."""
        out_r, out_n = [ray[:0]], [node[:0]]
        step = max(1, _SCALAR_CELLS // width)
        for s in range(0, ray.shape[0], step):
            r, n = ray[s:s + step], node[s:s + step]
            bx = boxes(n)
            tmin, ok = _slab([bx[:, a] for a in range(3)],
                             [bx[:, a + 3] for a in range(3)],
                             [o[a, r, None] for a in range(3)],
                             [inv[a, r, None] for a in range(3)])
            p, j = (ok & (tmin < md)).nonzero(as_tuple=True)
            out_r.append(r[p])
            out_n.append(n[p] * width + j)
        return torch.cat(out_r), torch.cat(out_n)

    for k in range(len(tree.sizes) - 1, 0, -1):
        tally[0].index_add_(0, ray, torch.ones_like(ray))
        tally[1].index_add_(0, ray, (tree.sizes[k - 1] - node * TREE_WIDTH)
                            .clamp(max=TREE_WIDTH))
        ray, node = frontier(lambda n: tree.nodes[off[k] + n], TREE_WIDTH,
                             ray, node)
    if ordered:  # (ray, cluster) -> (ray, sub-box), 8 triangles each
        nsub = S // SUB_SIZE
        tally[2].index_add_(0, ray, torch.full_like(ray, nsub))
        ray, node = frontier(lambda n: bvh.sub_boxes[n].transpose(1, 2),
                             nsub, ray, node)
        width = SUB_SIZE
    else:
        width = S
    tally[3].index_add_(0, ray, torch.full_like(ray, width))
    best = torch.full((R,), md, dtype=torch.float32, device=dev)
    bidx = torch.full((R,), -1, dtype=torch.int32, device=dev)
    slot = torch.arange(width, device=dev)
    tri = bvh.tri_data.view(C * S, 9)
    step = max(1, _SCALAR_CELLS // width)
    for s in range(0, ray.shape[0], step):
        r = ray[s:s + step]
        first = node[s:s + step] * width
        t = _triangle_t(tri[first[:, None] + slot],
                        [o[a, r].view(-1, 1, 1) for a in range(3)],
                        [rays[3 + a, r].view(-1, 1, 1) for a in range(3)]
                        )[..., 0]
        tmin, m = t.min(dim=1)  # the first smallest: the smallest index
        hit = tmin < md
        _take(best, bidx, r[hit], tmin[hit], (first + m)[hit])
    if counts is not None:
        counts.copy_(tally.T)
    return best, bidx


def _check_scalar_inputs(tree, bvh, rays: Tensor, ordered: bool,
                         counts: Optional[Tensor]) -> None:
    tri = bvh.tri_data
    if tri.dim() != 3 or tri.shape[2] != 9 or tri.dtype != torch.float32:
        raise ValueError(f"tri_data must be (C, S, 9) float32, got "
                         f"{tri.dtype} {tuple(tri.shape)}")
    C, S = tri.shape[:2]
    if tuple(bvh.boxes.shape) != (C, 6) or bvh.boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be ({C}, 6) float32")
    if C >= 1 << 27:
        raise ValueError(f"the scalar tier takes fewer than 2^27 clusters, "
                         f"got {C}")
    sizes = tree_sizes(C)
    N = sum(sizes[1:])
    if (tuple(tree.sizes) != sizes or tree.nodes.dtype != torch.float32
            or tuple(tree.nodes.shape) != (N, 6, TREE_WIDTH)):
        raise ValueError(f"tree must be the ClusterTree of {C} clusters: "
                         f"nodes ({N}, 6, {TREE_WIDTH}) float32, sizes "
                         f"{sizes}")
    if (rays.dim() != 2 or rays.shape[0] != 6 or rays.shape[1] < 1
            or rays.dtype != torch.float32):
        raise ValueError("rays must be (6, R) float32 with R >= 1")
    R = rays.shape[1]
    tensors = [tree.nodes, bvh.boxes, tri, rays]
    if ordered:
        nsub = S // SUB_SIZE
        if S % SUB_SIZE or nsub > 32:
            raise ValueError(f"ordered cast needs S % {SUB_SIZE} == 0 and "
                             f"S <= {32 * SUB_SIZE}, got {S}")
        if (tuple(bvh.sub_boxes.shape) != (C, nsub, 6)
                or bvh.sub_boxes.dtype != torch.float32):
            raise ValueError(f"sub_boxes must be ({C}, {nsub}, 6) float32")
        tensors.append(bvh.sub_boxes)
    if counts is not None:
        if tuple(counts.shape) != (R, 4) or counts.dtype != torch.int32:
            raise ValueError(f"counts must be ({R}, 4) int32")
        tensors.append(counts)
    for t in tensors:
        if t.device != rays.device:
            raise ValueError("all cast inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("cast inputs must be contiguous")


def _scalar(kernel, tree, bvh, rays, max_dist, counts, ordered):
    _check_scalar_inputs(tree, bvh, rays, ordered, counts)
    if rays.device.type == "cpu":
        return cluster_scalar_plain(tree, bvh, rays, max_dist, ordered,
                                    counts)
    if rays.device.type != "cuda":
        raise ValueError(f"unsupported device {rays.device}")
    dev = rays.device
    C, S = bvh.tri_data.shape[:2]
    R = rays.shape[1]
    depth = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    head = [tree.nodes.data_ptr()]
    if ordered:
        head.append(bvh.sub_boxes.data_ptr())
    with torch.cuda.device(dev):
        kernel.launch(*head, bvh.tri_data.data_ptr(), rays.data_ptr(), R, C,
                      S, float(max_dist), depth.data_ptr(), idx.data_ptr(),
                      counts.data_ptr() if counts is not None else None)
    return depth, idx


def cluster_scalar_ordered(tree, bvh, rays: Tensor, max_dist: float,
                           counts: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
    """Scalar-tier cast with the sub-box cull: (depth (R,), sorted idx
    (R,)), one warp per ray walking ``tree`` nearest child first.

    ``tree`` the :class:`~primitive3d_tpu_torch.bvh.clusters.ClusterTree`
    of ``bvh`` (a :class:`~primitive3d_tpu_torch.bvh.clusters.ClusterBVH`),
    ``rays`` (6, R) rows [o; d]. ``counts`` (R, 4) int32, if given,
    receives each ray's internal nodes entered, child boxes tested,
    sub-boxes tested and triangles tested. Launches
    ``csrc/cluster_scalar.cu`` for CUDA tensors and runs
    :func:`cluster_scalar_plain` (whose counts are those of the walk
    without pruning) for CPU tensors."""
    return _scalar(SCALAR_ORDERED, tree, bvh, rays, max_dist, counts, True)


def cluster_scalar(tree, bvh, rays: Tensor, max_dist: float,
                   counts: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Scalar-tier cast with the cluster cull only, children in index
    order; the arguments and outputs of :func:`cluster_scalar_ordered`."""
    return _scalar(SCALAR, tree, bvh, rays, max_dist, counts, False)


def cast_clusters(bvh, origins: Tensor, dirs: Tensor, max_dist: float = 10.0,
                  ordered: bool = True, tree=None) -> Tuple[Tensor, Tensor]:
    """Closest hit through the scalar-tier kernels: (t, sorted-triangle
    index) of rays (R, 3); map the index through ``bvh.prim_order`` for face
    ids.

    ``ordered`` adds the sub-box cull and walks nearest child first; both
    walks are exact. ``tree`` is ``bvh``'s
    :class:`~primitive3d_tpu_torch.bvh.clusters.ClusterTree`, built here
    when not given (a caster builds it once per mesh).
    """
    if tree is None:
        tree = build_cluster_tree(bvh.boxes)
    rays = torch.cat([origins, dirs], dim=1).T.contiguous()
    fn = cluster_scalar_ordered if ordered else cluster_scalar
    return fn(tree, bvh, rays, max_dist)


# --- backward: plane cotangents -> cluster-space rows ------------------------

# [n, entries, stride, B, widx, g, C, S, keys, nvalid, bitmap, out, passes]
PLANE_SCATTER = _build.Kernel(
    "plane_scatter", "plane_scatter.cu",
    replaces="primitive3d_tpu/kernels/raycast_kernel.py:1279",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int])


def _cluster_masks(n: Tensor, entries: Tensor, C: int) -> Tensor:
    """The stream work list per cluster: (C, B) int32, the chunk mask of
    cluster c's word in block b's list (0 where c is not listed)."""
    B, L = entries.shape
    dev = entries.device
    live = torch.arange(L, device=dev)[None, :] < n[:, None]
    slot = torch.where(
        live, (entries >> 16).to(torch.int64) * B
        + torch.arange(B, device=dev)[:, None], C * B)  # C * B: dump slot
    cm = torch.zeros(C * B + 1, dtype=torch.int32, device=dev)
    cm.scatter_(0, slot.reshape(-1), (entries & 0xFFFF).reshape(-1))
    return cm[:C * B].view(C, B)


def plane_scatter_plain(g: Tensor, widx: Tensor, n: Tensor, entries: Tensor,
                        C: int, S: int) -> Tensor:
    """Plain version of the plane scatter kernel: (C*S, 4) float32.

    Row ``c*S + j`` sums the cotangents ``g`` (Rp, 4) of the rays whose
    winner ``widx`` (Rp,) is ``c*S + j``, over the rays whose chunk is
    flagged for cluster c in their block's stream list ``(n, entries)``;
    other rays add nothing. Summed in float64 with ``index_add_``.
    """
    dev = g.device
    Rp = widx.shape[0]
    cm = _cluster_masks(n, entries, C)
    ray = torch.arange(Rp, device=dev)
    c = torch.div(widx, S, rounding_mode="floor").clamp(min=0).to(torch.int64)
    word = cm[c, ray // MBLOCK]
    ok = (widx >= 0) & (((word >> ((ray % MBLOCK) // RCHUNK)) & 1) == 1)
    out = torch.zeros((C * S, 4), dtype=torch.float64, device=dev)
    out.index_add_(0, widx.clamp(min=0).to(torch.int64),
                   torch.where(ok[:, None], g.to(torch.float64), 0.0))
    return out.to(torch.float32)


def plane_scatter(g: Tensor, widx: Tensor, n: Tensor, entries: Tensor,
                  C: int, S: int) -> Tensor:
    """Scatter per-ray plane cotangents into cluster-space rows (C*S, 4).

    ``g`` (Rp, 4) float32 and ``widx`` (Rp,) int32 (the sorted winner, -1
    for none) over rays padded to a multiple of MBLOCK; ``(n, entries)`` the
    forward's stream work list. Launches ``csrc/plane_scatter.cu`` for CUDA
    tensors (each row summed in float32 in ascending ray order: the same
    bits on every launch) and runs :func:`plane_scatter_plain` for CPU
    tensors.
    """
    Rp = widx.shape[0]
    if Rp % MBLOCK or tuple(widx.shape) != (Rp,) or widx.dtype != torch.int32:
        raise ValueError(f"widx must be (Rp,) int32 with Rp % {MBLOCK} == 0")
    if tuple(g.shape) != (Rp, 4) or g.dtype != torch.float32:
        raise ValueError(f"g must be ({Rp}, 4) float32")
    B = Rp // MBLOCK
    if tuple(n.shape) != (B,) or n.dtype != torch.int32:
        raise ValueError(f"n must be ({B},) int32")
    if (entries.dim() != 2 or entries.shape[0] != B
            or entries.dtype != torch.int32):
        raise ValueError(f"entries must be ({B}, L) int32")
    if S > MAX_CLUSTER_SIZE or S & (S - 1):
        raise ValueError(f"cluster size must be a power of two <= "
                         f"{MAX_CLUSTER_SIZE}, got {S}")
    if any(t.device != g.device for t in (widx, n, entries)):
        raise ValueError("all plane scatter inputs must be on one device")
    if not 1 <= C <= STREAM_MAX_CLUSTERS:
        raise ValueError(f"C must be in [1, {STREAM_MAX_CLUSTERS}], got {C}")
    if g.device.type == "cpu":
        return plane_scatter_plain(g, widx, n, entries, C, S)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if (not all(t.is_contiguous() for t in (g, widx, n, entries))
            or g.data_ptr() % 16):
        raise ValueError("plane scatter inputs must be contiguous, g 16-byte "
                         "aligned")
    out = torch.empty((C * S, 4), dtype=torch.float32, device=g.device)
    _plane_scatter_passes(g, widx, n, entries, C, S, out,
                          _scatter_scratch(B, C, g.device), 3)
    return out


def _scatter_scratch(B: int, C: int, dev) -> Tuple[Tensor, Tensor, Tensor]:
    """The plane scatter kernel's scratch: sorted keys (B * MBLOCK,),
    per-block key counts (B,) and the (cluster, block) bitmap."""
    return (torch.empty((B * MBLOCK,), dtype=torch.int64, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((C * (-(-B // 32)),), dtype=torch.int32, device=dev))


def _plane_scatter_passes(g, widx, n, entries, C, S, out, scratch,
                          passes: int) -> None:
    """Launch the plane scatter's passes (bit 0: the keys, bit 1: the
    sums; 3 is the function) on checked CUDA inputs. A single pass is for
    timing it alone, with the scratch of an earlier launch."""
    keys, nvalid, bitmap = scratch
    with torch.cuda.device(g.device):
        PLANE_SCATTER.launch(
            n.data_ptr(), entries.data_ptr(), entries.shape[1], n.shape[0],
            widx.data_ptr(), g.data_ptr(), C, S, keys.data_ptr(),
            nvalid.data_ptr(), bitmap.data_ptr(), out.data_ptr(), passes)


class _PlanesSelect(torch.autograd.Function):
    """The winners' plane rows ``planes[max(prim, 0)]``, taken from the
    cast kernel's fin rows; the backward scatter-adds the cotangents of the
    hit rays (prim >= 0) into ``planes`` (resident tier)."""

    @staticmethod
    def forward(ctx, planes, prim, fin4):
        ctx.save_for_backward(prim)
        ctx.T = planes.shape[0]
        return fin4.clone()

    @staticmethod
    def backward(ctx, g):
        (prim,) = ctx.saved_tensors
        dplanes = torch.zeros((ctx.T, 4), dtype=g.dtype, device=g.device)
        dplanes.index_add_(0, prim.clamp(min=0).to(torch.int64),
                           torch.where((prim >= 0)[:, None], g, 0.0))
        return dplanes, None, None


class _PlanesSelectWS(torch.autograd.Function):
    """As :class:`_PlanesSelect`, with the backward on the plane scatter
    kernel over the forward's stream work list. Needs clusters in identity
    order: cluster space is face space, padded to C*S rows."""

    @staticmethod
    def forward(ctx, planes, prim, fin4, sidx, n, entries, S):
        ctx.save_for_backward(prim, sidx, n, entries)
        ctx.T, ctx.S = planes.shape[0], S
        return fin4.clone()

    @staticmethod
    def backward(ctx, g):
        prim, sidx, n, entries = ctx.saved_tensors
        R = sidx.shape[0]
        Rp = n.shape[0] * MBLOCK
        gp = torch.zeros((Rp, 4), dtype=torch.float32, device=g.device)
        gp[:R] = torch.where((prim >= 0)[:, None], g, 0.0)
        wp = torch.full((Rp,), -1, dtype=torch.int32, device=g.device)
        wp[:R] = sidx
        C = -(-ctx.T // ctx.S)
        dsorted = plane_scatter(gp, wp, n, entries, C, ctx.S)
        return dsorted[:ctx.T], None, None, None, None, None, None


def cast_clusters_diff(tris: Tensor, origins: Tensor, dirs: Tensor, bvh=None,
                       max_dist: float = 10.0,
                       mxu_max_tris: Optional[int] = None,
                       mxu_stream_max_tris: Optional[int] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Differentiable closest hit: (depth, original-triangle index).

    The cluster kernels find each ray's hit triangle with no gradient (the
    assignment is discrete); depth is then recomputed from that triangle's
    plane, ``t = (a.n - o.n) / d.n``, so gradients reach ``tris`` and the
    rays with the hit held fixed. Without ``bvh`` the clusters are built
    from ``tris.detach()``: in identity order up to ``mxu_stream_max_tris``
    (default 32767 clusters of 128) triangles, where meshes of more than
    ``ClusterRayCaster.MXU_MAX_TRIS`` take the stream tier, whose backward
    runs the plane scatter kernel over the forward's work list; Morton-order
    clusters of 128 for the scalar-broadcast tier above, whose backward is
    autograd's own gather backward.
    """
    from ..bvh.clusters import CLUSTER_SIZE, build_clusters, build_mxu_clusters
    from ..raycast import ClusterRayCaster

    cap = (ClusterRayCaster.MXU_MAX_TRIS if mxu_max_tris is None
           else mxu_max_tris)
    scap = (STREAM_MAX_CLUSTERS * CLUSTER_SIZE if mxu_stream_max_tris is None
            else mxu_stream_max_tris)
    T = tris.shape[0]
    use_mxu = bvh is not None or T <= scap
    identity = bvh is None and use_mxu
    if bvh is None:
        bvh = (build_mxu_clusters(tris.detach(), order="identity") if use_mxu
               else build_clusters(tris.detach()))
    stream = T > cap
    # each face's plane [n, a.n], differentiable. The 3-term sums here and
    # below are written out (dot3), so the card and the CPU round alike: a
    # grazing hit's t = num / den magnifies a one-ulp difference of den
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    nrm = torch.linalg.cross(b - a, c - a, dim=-1)
    planes = torch.cat([nrm, dot3(a, nrm)[:, None]], dim=-1)
    if not use_mxu:
        with torch.no_grad():
            _, sidx = cast_clusters(bvh, origins.detach(), dirs.detach(),
                                    max_dist)
        prim = bvh.prim_order[sidx.clamp(min=0).to(torch.int64)]
        hit = (sidx >= 0) & (prim >= 0)
        pr = planes[prim.clamp(min=0).to(torch.int64)]
        prim = torch.where(hit, prim, -1)
    else:
        with torch.no_grad():
            (_, sidx, finr), (n, work) = _cast_with_list(
                bvh, origins.detach(), dirs.detach(), max_dist, stream,
                with_fin=True, edge_wildcard=False)
        fid_f = finr[:, 5]
        hit = (sidx >= 0) & (fid_f >= 0.0)
        prim = torch.where(hit, fid_f.to(torch.int32), -1)
        if identity and stream:
            pr = _PlanesSelectWS.apply(planes, prim, finr[:, :4], sidx, n,
                                       work, bvh.cluster_size)
        else:
            pr = _PlanesSelect.apply(planes, prim, finr[:, :4])
    den = dot3(dirs, pr[:, :3])
    num = pr[:, 3] - dot3(origins, pr[:, :3])
    t = num / torch.where(den == 0, torch.full_like(den, 1e-30), den)
    depth = torch.where(hit, t, torch.full_like(t, float(max_dist)))
    return depth, prim
