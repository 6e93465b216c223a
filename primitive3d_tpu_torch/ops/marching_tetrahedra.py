"""Differentiable marching tetrahedra (DMTet-style), in plain PyTorch.

Counterpart of ``primitive3d_tpu/ops/marching_tetrahedra.py``, which runs no
Pallas kernel: its sorts, scans and gathers become ``torch.sort``,
``torch.cumsum`` and gathers here. The output is the JAX package's, exactly:

  * vertices are the unique sign-crossing tet edges in lexicographic order
    of their (min, max) vertex pairs (``torch.unique`` order), each placed
    by the SDF-weighted interpolation of its two ends;
  * faces follow ascending tet index, then the triangle of the table;
    windings come from the tets after the orientation flip (a tet of
    negative signed volume swaps its corners 0 and 1);
  * the padded tails are zero (vertices, faces) and -1 (``tet_idx``).

Two tiers, as in the JAX package:

  * the sort tier (:func:`marching_tetrahedra_padded`, eager
    :func:`marching_tetrahedra`) for any tet mesh. Its edge dedup is one
    stable sort of packed int64 keys ``min * (N + 1) + max``. Past
    ``_DENSE_MAX_TETS`` tets it first compacts the active tets to
    ``A = min(face_capacity, T)``, as the JAX package's T-major tier does,
    so on a face overflow it counts only the crossing edges of the first A
    active tets; below, ``A = T`` and nothing is compacted. The JAX
    package's two sort tiers (dense and T-major) differ only in their TPU
    memory layout and in this cap, so here they are one function.
  * the lattice tier (:func:`marching_tetrahedra_lattice`) for the Kuhn
    6-tet grid of :func:`grid_tetrahedra`: no sort, edge ids computed from
    the lattice, output-identical to the sort tier.

Both are differentiable with respect to ``vertices`` and ``sdf`` through
autograd; everything discrete is integer or detached. The input ``tets`` is
never mutated. No host sync but the eager call's one read of the counts.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core import debug
from ..core.device import DeviceLike, as_tensor, resolve_device
from .marching_cubes import _compact_src, _excl_cumsum

Tensor = torch.Tensor

# Local tet edges 0..5 connect corners TET_EDGES[e].
TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# MT_TRI_TABLE[mask] -> up to 2 triangles as local-edge ids, -1 padded, where
# mask bit i is set iff sdf[corner i] > 0.
MT_TRI_TABLE = np.array(
    [
        [-1, -1, -1, -1, -1, -1],  # 0000
        [1, 0, 2, -1, -1, -1],  # 0001
        [4, 0, 3, -1, -1, -1],  # 0010
        [1, 4, 2, 1, 3, 4],  # 0011
        [3, 1, 5, -1, -1, -1],  # 0100
        [2, 3, 0, 2, 5, 3],  # 0101
        [1, 4, 0, 1, 5, 4],  # 0110
        [4, 2, 5, -1, -1, -1],  # 0111
        [4, 5, 2, -1, -1, -1],  # 1000
        [4, 1, 0, 4, 5, 1],  # 1001
        [3, 2, 0, 3, 5, 2],  # 1010
        [1, 3, 5, -1, -1, -1],  # 1011
        [4, 1, 2, 4, 3, 1],  # 1100
        [3, 0, 4, -1, -1, -1],  # 1101
        [2, 0, 1, -1, -1, -1],  # 1110
        [-1, -1, -1, -1, -1, -1],  # 1111
    ],
    dtype=np.int32,
)
MT_NUM_TRIS = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], dtype=np.int32
)

# Past this many tets the sort tier compacts the active tets first.
_DENSE_MAX_TETS = 500_000


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[Tensor, Tensor]:
    """(MT_TRI_TABLE (16, 6), MT_NUM_TRIS (16,)) as int64 on ``device``."""
    return (torch.as_tensor(MT_TRI_TABLE, dtype=torch.int64, device=device),
            torch.as_tensor(MT_NUM_TRIS, dtype=torch.int64, device=device))


class MTResult(NamedTuple):
    """Padded marching-tetrahedra output (fixed shapes)."""

    vertices: Tensor  # (vert_capacity, 3) float32
    faces: Tensor  # (face_capacity, 3) int32
    tet_idx: Tensor  # (face_capacity,) int32, -1 padded
    num_vertices: Tensor  # () int32
    num_faces: Tensor  # () int32

    @property
    def overflowed(self) -> Tensor:
        return ((self.num_vertices > self.vertices.shape[0])
                | (self.num_faces > self.faces.shape[0]))


def _negative(vg: Tensor, c0: Tensor, c1: Tensor, c2: Tensor,
              c3: Tensor) -> Tensor:
    """Tets of negative signed volume: the triple product
    det([c1 - c0, c2 - c0, c3 - c0]) of the (detached) positions ``vg``,
    written out term by term as the JAX package writes it."""
    x, y, z = vg[:, 0], vg[:, 1], vg[:, 2]

    def e(tc):
        return x[tc] - x[c0], y[tc] - y[c0], z[tc] - z[c0]

    e1x, e1y, e1z = e(c1)
    e2x, e2y, e2z = e(c2)
    e3x, e3y, e3z = e(c3)
    dets = ((e1y * e2z - e1z * e2y) * e3x
            + (e1z * e2x - e1x * e2z) * e3y
            + (e1x * e2y - e1y * e2x) * e3z)
    return dets < 0


def _interp_weights(s_a: Tensor, s_b: Tensor) -> Tuple[Tensor, Tensor]:
    """Weights of the two edge ends at the SDF's zero crossing."""
    denom = s_a - s_b
    denom = torch.where(denom.abs() < 1e-20, torch.full_like(denom, 1e-20),
                        denom)
    return -s_b / denom, s_a / denom


def _mt_sort_impl(vertices: Tensor, tets: Tensor, sdf: Tensor,
                  vert_capacity: int, face_capacity: int,
                  compact: bool) -> MTResult:
    """The sort tier; ``compact`` first keeps the first A = min(
    face_capacity, T) active tets (each emits a face, so A of them fill
    every face slot whenever the cap cuts any off), else A = T."""
    dev = vertices.device
    tri_table, num_tris = _tables(dev)
    N, T = vertices.shape[0], tets.shape[0]
    A = min(face_capacity, T) if compact else T
    E = 6 * A

    # --- per-tet occupancy and face count (before any compaction) --------
    occ = sdf.detach() > 0
    tcols = [tets[:, c] for c in range(4)]
    occ_sum = sum(occ[c].to(torch.int64) for c in tcols)
    valid_tet = (occ_sum > 0) & (occ_sum < 4)
    # two faces for two-in / two-out, one otherwise, none if inactive
    num_faces = torch.where(valid_tet, torch.where(occ_sum == 2, 2, 1),
                            0).sum()

    # --- the first A active tets, in order ------------------------------
    if A < T:
        asrc = _compact_src(valid_tet, _excl_cumsum(valid_tet), A)
        act_valid = torch.arange(A, device=dev) < valid_tet.sum()
        tcols = [c[asrc] for c in tcols]
    else:
        asrc = torch.arange(T, device=dev)
        act_valid = valid_tet
    c0, c1, c2, c3 = tcols
    neg = _negative(vertices.detach(), c0, c1, c2, c3)
    corners = (torch.where(neg, c1, c0), torch.where(neg, c0, c1), c2, c3)

    # --- edge dedup: one stable sort of packed (min, max) keys -----------
    # edge-major flat index e * A + t; inactive slots get the sentinel
    # pair (N, N), which sorts last
    ea = torch.stack([torch.minimum(corners[a], corners[b])
                      for a, b in TET_EDGES])
    eb = torch.stack([torch.maximum(corners[a], corners[b])
                      for a, b in TET_EDGES])
    key = torch.where(act_valid, ea * (N + 1) + eb, N * (N + 1) + N)
    skey, sidx = torch.sort(key.reshape(E), stable=True)
    sa, sb = skey // (N + 1), skey % (N + 1)
    head = torch.ones(E, dtype=torch.bool, device=dev)
    head[1:] = skey[1:] != skey[:-1]
    occ_ext = torch.cat([occ, occ.new_zeros(1)])
    # a group's pairs are equal, so each of its entries knows whether the
    # group is a crossing edge; its vertex id is the inclusive count of new
    # vertices up to its head, which no later entry of the group adds to
    live = (sa < N) & (occ_ext[sa] != occ_ext[sb])
    is_new = head & live
    incl_v = torch.cumsum(is_new, 0)
    num_vertices = incl_v[-1] if E else incl_v.new_zeros(())
    vid_sorted = torch.where(live, incl_v - 1, -1)
    edge_vid = torch.empty_like(vid_sorted).scatter_(0, sidx, vid_sorted)

    # --- vertex positions of the first vert_capacity new vertices ---------
    src = _compact_src(is_new, _excl_cumsum(is_new), vert_capacity)
    slot = torch.arange(vert_capacity, device=dev)
    valid_v = slot < num_vertices
    # empty slots read spread-out vertices (their values are masked): on the
    # card, autograd's index backward sums each run of equal indices in one
    # warp, so tens of thousands of slots on one vertex would serialise it
    a_idx = torch.where(valid_v, sa[src], slot % N)
    b_idx = torch.where(valid_v, sb[src], slot % N)
    w_a, w_b = _interp_weights(sdf[a_idx], sdf[b_idx])
    pos = torch.stack([vertices[:, c][a_idx] * w_a
                       + vertices[:, c][b_idx] * w_b for c in range(3)], -1)
    verts = torch.where(valid_v[:, None], pos, torch.zeros_like(pos))

    # --- faces: slot -> (active tet, triangle k) -------------------------
    occ_a = [occ[c].to(torch.int64) for c in corners]
    table_idx = occ_a[0] + 2 * occ_a[1] + 4 * occ_a[2] + 8 * occ_a[3]
    ntris = torch.where(act_valid, num_tris[table_idx], 0)
    incl = torch.cumsum(ntris, 0)
    q = torch.arange(face_capacity, device=dev)
    tet_a = torch.searchsorted(incl, q, right=True).clamp_(max=A - 1)
    k = (q - (incl - ntris)[tet_a]).clamp(0, 1)
    valid_f = q < num_faces
    tri_rows = tri_table[table_idx[tet_a]]
    fcols = []
    for j in range(3):
        ejk = tri_rows.gather(1, (3 * k + j)[:, None])[:, 0]
        vid = edge_vid[ejk.clamp(min=0) * A + tet_a]
        fcols.append(torch.where(valid_f, vid, 0))
    faces = torch.stack(fcols, dim=-1).to(torch.int32)
    tet_of_face = torch.where(valid_f, asrc[tet_a], -1).to(torch.int32)
    return MTResult(verts, faces, tet_of_face, num_vertices.to(torch.int32),
                    num_faces.to(torch.int32))


def _check_inputs(vertices: Tensor, tets: Tensor, sdf: Tensor) -> None:
    if vertices.ndim != 2 or vertices.shape[-1] != 3:
        raise ValueError(
            f"vertices must be (N, 3), got {tuple(vertices.shape)}")
    if tets.ndim != 2 or tets.shape[-1] != 4:
        raise ValueError(f"tets must be (T, 4), got {tuple(tets.shape)}")
    if tuple(sdf.shape) != (vertices.shape[0],):
        raise ValueError(f"sdf must be (N,), got {tuple(sdf.shape)}")
    if debug.enabled():
        debug.check(((tets >= 0) & (tets < vertices.shape[0])).all(),
                    "marching_tetrahedra: tet vertex index out of range")
    debug.check_finite(sdf, "sdf")


def marching_tetrahedra_padded(
    vertices,
    tets,
    sdf,
    *,
    vert_capacity: int,
    face_capacity: int,
    device: DeviceLike = "cuda",
) -> MTResult:
    """Differentiable marching tetrahedra with padded outputs.

    Capacity bounds: at most ``6 * num_tets`` vertices (in practice far
    fewer: unique crossing edges) and ``2 * num_tets`` faces. The inputs go
    to ``device``; the gradient reaches tensor ``vertices`` and ``sdf``.
    """
    dev = resolve_device(device)
    vertices = as_tensor(vertices, torch.float32, dev)
    tets = as_tensor(tets, torch.int64, dev)
    sdf = as_tensor(sdf, torch.float32, dev)
    _check_inputs(vertices, tets, sdf)
    return _mt_sort_impl(vertices, tets, sdf, int(vert_capacity),
                         int(face_capacity), tets.shape[0] > _DENSE_MAX_TETS)


def marching_tetrahedra(
    vertices,
    tets,
    sdf,
    return_tet_idx: bool = False,
    device: DeviceLike = "cuda",
) -> Union[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor, Tensor]]:
    """Eager marching tetrahedra: exact-size (vertices, faces[, tet_idx]).

    Capacities 6T and 2T, then one host read of the counts. Differentiable
    through the returned vertices; ``tets`` is not mutated.
    """
    T = len(tets)
    res = marching_tetrahedra_padded(vertices, tets, sdf,
                                     vert_capacity=6 * T,
                                     face_capacity=2 * T, device=device)
    nv, nf = (int(x) for x in torch.stack([res.num_vertices,
                                           res.num_faces]).tolist())
    if return_tet_idx:
        return res.vertices[:nv], res.faces[:nf], res.tet_idx[:nf]
    return res.vertices[:nv], res.faces[:nf]


# ---------------------------------------------------------------------------
# Lattice tier: analytic edge numbering for Kuhn 6-tet grids (no sorts).
# ---------------------------------------------------------------------------
# The unique edges of the Kuhn complex over an (n, n, n) vertex lattice fall
# in 7 direction classes, and the lexicographic (min, max) vertex-pair order
# is point-major with the directions in ascending flat-id delta: z, y, yz,
# x, xz, xy, xyz, as (dx, dy, dz).
_LATTICE_DIRS = (
    (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0),
    (1, 0, 1), (1, 1, 0), (1, 1, 1),
)
# Kuhn 6-tet paths around the (0 -> 7) cell diagonal, in grid_tetrahedra's
# emission order (tet index t = cell * 6 + path).
_KUHN_PATHS = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
               (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7))


def _popcount7(x: Tensor) -> Tensor:
    """Set bits of the low 7 bits of an integer tensor, counted exactly."""
    return sum((x >> i) & 1 for i in range(7))


def _lattice_fields(occ3: Tensor, n: int):
    """Per-point 7-bit crossing byte (bit di: the edge from p in direction
    ``_LATTICE_DIRS[di]`` is in range and crosses), per-point crossing
    totals, and their exclusive prefix sum in point order. The global id of
    crossing edge (p, di) is ``excl_pt[p] + popcount(cbyte[p] & ((1 << di)
    - 1))``: the analytic replacement of the sort tier's dedup."""
    N = n * n * n
    cbyte = torch.zeros(N, dtype=torch.int64, device=occ3.device)
    tot = torch.zeros(N, dtype=torch.int64, device=occ3.device)
    for di, (dx, dy, dz) in enumerate(_LATTICE_DIRS):
        c = torch.zeros((n, n, n), dtype=torch.int64, device=occ3.device)
        c[: n - dx, : n - dy, : n - dz] = (
            occ3[: n - dx, : n - dy, : n - dz] != occ3[dx:, dy:, dz:])
        c = c.reshape(N)
        cbyte = cbyte + (c << di)
        tot = tot + c
    return cbyte, tot, torch.cumsum(tot, 0) - tot


def _mt_lattice_impl(vertices: Optional[Tensor], sdf: Tensor, n: int,
                     vert_capacity: int, face_capacity: int) -> MTResult:
    """Marching tetrahedra over the Kuhn lattice: zero sorts.

    Crossing masks are shifted compares, vertex ids one prefix scan in
    point order, and slot decodes two ``searchsorted`` calls over n^3
    points and (n - 1)^3 cells. ``vertices`` None is the index-space
    lattice, whose positions are decoded, not gathered.
    """
    dev = sdf.device
    tri_table, _ = _tables(dev)
    N = n * n * n
    occ3 = (sdf.detach() > 0).reshape(n, n, n)
    cbyte, tot, excl_pt = _lattice_fields(occ3, n)
    incl_pt = excl_pt + tot
    num_vertices = incl_pt[N - 1]
    dirs = torch.tensor(_LATTICE_DIRS, dtype=torch.int64, device=dev)
    deltas = [(dx * n + dy) * n + dz for dx, dy, dz in _LATTICE_DIRS]
    delta_t = torch.tensor(deltas, dtype=torch.int64, device=dev)

    # --- vertices: slot -> (point, direction) -----------------------------
    q = torch.arange(vert_capacity, device=dev)
    valid_v = q < num_vertices
    # empty slots take spread-out points, as in the sort tier
    p = torch.where(valid_v, torch.searchsorted(incl_pt, q + 1), q % N)
    r = q - excl_pt[p]  # rank within the point's crossing byte
    cb = cbyte[p]
    di = torch.zeros_like(r)
    cnt = torch.zeros_like(r)
    for i in range(7):
        bit = (cb >> i) & 1
        di = torch.where((cnt == r) & (bit == 1), i, di)
        cnt = cnt + bit
    b_idx = (p + delta_t[di]).clamp_(max=N - 1)
    w_a, w_b = _interp_weights(sdf[p], sdf[b_idx])
    if vertices is None:
        d = dirs[di].to(torch.float32)
        cols = [(p // (n * n)).to(torch.float32) + d[:, 0] * w_b,
                ((p // n) % n).to(torch.float32) + d[:, 1] * w_b,
                (p % n).to(torch.float32) + d[:, 2] * w_b]
    else:
        cols = [vertices[:, c][p] * w_a + vertices[:, c][b_idx] * w_b
                for c in range(3)]
    pos = torch.stack(cols, -1)
    verts = torch.where(valid_v[:, None], pos, torch.zeros_like(pos))

    # --- faces: per-cell triangle counts, slot -> (cell, path, k) --------
    C = (n - 1) ** 3
    occ_c = [occ3[(c >> 0) & 1: n - 1 + ((c >> 0) & 1),
                  (c >> 1) & 1: n - 1 + ((c >> 1) & 1),
                  (c >> 2) & 1: n - 1 + ((c >> 2) & 1)].reshape(C)
             .to(torch.int64) for c in range(8)]
    packed_nt = torch.zeros(C, dtype=torch.int64, device=dev)
    celltot = torch.zeros(C, dtype=torch.int64, device=dev)
    for pth, quad in enumerate(_KUHN_PATHS):
        s4 = sum(occ_c[c] for c in quad)
        nt = torch.where((s4 > 0) & (s4 < 4), torch.where(s4 == 2, 2, 1), 0)
        packed_nt = packed_nt + (nt << (2 * pth))
        celltot = celltot + nt
    incl_cell = torch.cumsum(celltot, 0)
    excl_cell = incl_cell - celltot
    num_faces = incl_cell[C - 1]

    s_q = torch.arange(1, face_capacity + 1, device=dev)
    cell = torch.searchsorted(incl_cell, s_q).clamp_(0, C - 1)
    rr = (s_q - 1) - excl_cell[cell]
    w = packed_nt[cell]
    path = torch.zeros_like(rr)
    kk = torch.zeros_like(rr)
    cnt = torch.zeros_like(rr)
    for pth in range(6):
        ntp = (w >> (2 * pth)) & 3
        hit = (rr >= cnt) & (rr < cnt + ntp)
        path = torch.where(hit, pth, path)
        kk = torch.where(hit, rr - cnt, kk)
        cnt = cnt + ntp
    valid_f = s_q <= num_faces

    # corner flat ids of the face's tet, from its cell and path
    nm1 = n - 1
    base_pt = ((cell // (nm1 * nm1)) * n + (cell // nm1) % nm1) * n \
        + cell % nm1

    def corner_flat(i):
        offs = [(((code & 1) * n + ((code >> 1) & 1)) * n + ((code >> 2) & 1))
                for code in (quad[i] for quad in _KUHN_PATHS)]
        return base_pt + torch.tensor(offs, device=dev)[path]

    p0, p1, p2, p3 = (corner_flat(i) for i in range(4))
    # orientation from the true positions (a deformed lattice can invert
    # cells; the index-space Kuhn tets are all positive)
    if vertices is None:
        neg = torch.zeros_like(valid_f)
    else:
        neg = _negative(vertices.detach(), p0, p1, p2, p3)
    quad4 = torch.stack([torch.where(neg, p1, p0), torch.where(neg, p0, p1),
                         p2, p3], -1)
    occ_flat = occ3.reshape(N).to(torch.int64)
    o = occ_flat[quad4]
    table_idx = o[:, 0] + 2 * o[:, 1] + 4 * o[:, 2] + 8 * o[:, 3]
    tri_rows = tri_table[table_idx]
    tet_edges = torch.as_tensor(TET_EDGES, dtype=torch.int64, device=dev)

    # local edge -> global crossing-edge id, from the lattice
    fcols = []
    for j in range(3):
        ejk = tri_rows.gather(1, (3 * kk + j)[:, None])[:, 0]
        ends = tet_edges[ejk.clamp(min=0)]
        pa = quad4.gather(1, ends[:, :1])[:, 0]
        pb = quad4.gather(1, ends[:, 1:])[:, 0]
        lo = torch.minimum(pa, pb)
        dflat = (pa - pb).abs()
        dsel = torch.zeros_like(dflat)
        for i, dv in enumerate(deltas):
            dsel = torch.where(dflat == dv, i, dsel)
        below = (torch.ones_like(dsel) << dsel) - 1
        vid = excl_pt[lo] + _popcount7(cbyte[lo] & below)
        fcols.append(torch.where(valid_f, vid, 0))
    faces = torch.stack(fcols, dim=-1).to(torch.int32)
    tet_of_face = torch.where(valid_f, cell * 6 + path, -1).to(torch.int32)
    return MTResult(verts, faces, tet_of_face, num_vertices.to(torch.int32),
                    num_faces.to(torch.int32))


def marching_tetrahedra_lattice(
    vertices,
    sdf,
    n: int,
    *,
    vert_capacity: int,
    face_capacity: int,
    device: DeviceLike = "cuda",
) -> MTResult:
    """Marching tetrahedra over the Kuhn 6-tet lattice: the sort-free tier.

    The same result as ``marching_tetrahedra_padded(vertices,
    grid_tetrahedra(n)[1], sdf, ...)`` (vertex and face order, windings,
    tet_idx) when the tet mesh is the Kuhn lattice. ``vertices`` may be
    ``None`` for the undeformed index-space lattice. Differentiable with
    respect to ``vertices`` and ``sdf``; general tet meshes use
    :func:`marching_tetrahedra_padded`.
    """
    dev = resolve_device(device)
    sdf = as_tensor(sdf, torch.float32, dev)
    N = n * n * n
    if vertices is not None:
        vertices = as_tensor(vertices, torch.float32, dev)
        if tuple(vertices.shape) != (N, 3):
            raise ValueError(
                f"vertices must be ({N}, 3) for lattice n={n}, "
                f"got {tuple(vertices.shape)}")
    if tuple(sdf.shape) != (N,):
        raise ValueError(f"sdf must be ({N},) for lattice n={n}, "
                         f"got {tuple(sdf.shape)}")
    debug.check_finite(sdf, "sdf")
    return _mt_lattice_impl(vertices, sdf, n, int(vert_capacity),
                            int(face_capacity))


def grid_tetrahedra(n: int):
    """Kuhn 6-tetrahedra split of an (n, n, n) vertex lattice.

    Vertices are the n^3 lattice points (index space); every cell
    [i,i+1]x[j,j+1]x[k,k+1] splits into the six tetrahedra along its main
    diagonal (0,7): (0,1,3,7), (0,3,2,7), (0,2,6,7), (0,6,4,7), (0,4,5,7),
    (0,5,1,7) with corner c at offset ((c>>0)&1, (c>>1)&1, (c>>2)&1).
    Returns numpy ``(points (n^3, 3) float32, tets (6*(n-1)^3, 4) int32)``.
    """
    ax = np.arange(n, dtype=np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    i, j, k = np.meshgrid(np.arange(n - 1), np.arange(n - 1),
                          np.arange(n - 1), indexing="ij")
    base = ((i * n + j) * n + k).reshape(-1)  # corner 0 of each cell

    def corner(c):
        dx, dy, dz = (c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1
        return base + (dx * n + dy) * n + dz

    tets = np.stack(
        [np.stack([corner(c) for c in quad], axis=-1) for quad in _KUHN_PATHS],
        axis=1,
    ).reshape(-1, 4).astype(np.int32)
    return pts, tets
