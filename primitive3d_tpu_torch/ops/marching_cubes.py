"""Marching cubes on dense density grids (PyTorch).

Counterpart of ``primitive3d_tpu/ops/marching_cubes.py``: the counts pass,
``marching_cubes_padded`` and the eager ``marching_cubes`` (indexed mesh),
and the single-grid ``marching_cubes_soup`` (triangle soup). Both padded
forms are differentiable with respect to the density through autograd, with
the soup's segment-sum backward written out (``_SlotRows``). The output is
the JAX package's, in the same order:

  * vertex ids number the crossing edges x-axis first (C order of the
    (X-1, Y, Z) edge grid), then y, then z;
  * faces follow ascending active cube (C order), then the within-cube
    triangle k of the table;
  * the padded tails are zero.

The TPU-shaped scans and decoders of the JAX package (``_excl_cumsum_flat``,
``_ntris_vec``, ``_twolevel_src``, ``_expand_src``) become ``torch.cumsum``,
a table gather, a scatter of each selected element to its scan slot, and
``torch.searchsorted``. None of them syncs with the host: the eager
``marching_cubes`` reads the counts back once, as the JAX package does.
Indices are int64 (a 256^3 grid has ~50M edges); faces and the returned
counts come out int32, as in the JAX package.

``thresh`` may be a Python float or a 0-d tensor. The mask pass takes its
value (one host read for a tensor on the card); the position math keeps the
tensor, so autograd gives its gradient, as the JAX package's VJPs do.

The mask pass is ``kernels.mc_masks.fused_masks``: the CUDA kernel on the
card, its plain version on the CPU.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..core import debug
from ..core.device import DeviceLike, as_tensor, resolve_device
from ..core.grid import ScaleLike, resolve_bounds
from ..kernels.mc_masks import fused_masks
from . import mc_tables as T

Tensor = torch.Tensor
ThreshLike = Union[float, Tensor]  # a Python float or a 0-d tensor
MAX_TRIS_PER_CUBE = T.MAX_TRIS_PER_CUBE


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[Tensor, Tensor]:
    """(NUM_TRIS (256,) int32, flat PACKED_TRI (256*5,) int32) on device."""
    return (torch.as_tensor(T.NUM_TRIS, dtype=torch.int32, device=device),
            torch.as_tensor(T.PACKED_TRI.reshape(-1), dtype=torch.int32,
                            device=device))


class MCResult(NamedTuple):
    """Padded marching-cubes output (fixed shapes).

    ``vertices[:num_vertices]`` and ``faces[:num_faces]`` are valid; the tail
    is zero padding. ``num_*`` may exceed the capacity if the buffers
    overflowed — check ``overflowed`` before trusting a padded result.
    """

    vertices: Tensor  # (vert_capacity, 3) float32
    faces: Tensor  # (face_capacity, 3) int32
    num_vertices: Tensor  # () int32 (true count, may exceed capacity)
    num_faces: Tensor  # () int32
    # () bool: the active-cube budget ran out (or False, as in the JAX type)
    unit_overflow: Union[Tensor, bool] = False

    @property
    def overflowed(self) -> Tensor:
        return ((self.num_vertices > self.vertices.shape[0])
                | (self.num_faces > self.faces.shape[0])
                | self.unit_overflow)


def _excl_cumsum(x: Tensor) -> Tensor:
    """Exclusive prefix sum of a flat 0/1 or small-count tensor, int32."""
    incl = torch.cumsum(x, 0, dtype=torch.int32)
    return incl - x.to(torch.int32)


def _compact_src(mask: Tensor, excl: Tensor, capacity: int) -> Tensor:
    """Indices of the first ``capacity`` set elements of ``mask``, in order.

    Each set element writes its own index to its exclusive-scan slot; the
    elements past the capacity and the unset ones all go to one dump slot
    that is cut off. Slots past the set count stay zero.
    """
    slot = torch.where(mask & (excl < capacity), excl.to(torch.int64),
                       capacity)
    src = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    src.scatter_(0, slot, torch.arange(mask.numel(), dtype=torch.int64,
                                       device=mask.device))
    return src[:capacity]


def _decode_edge(src: Tensor, shape):
    """Global edge ids (x-block, then y, then z; C order each) -> axis
    flags, lattice coords (i, j, k) and density-flat endpoint indices."""
    X, Y, Z = shape
    Ex = (X - 1) * Y * Z
    Ey = X * (Y - 1) * Z
    is_x = src < Ex
    is_y = (src >= Ex) & (src < Ex + Ey)
    is_z = ~(is_x | is_y)
    lx, ly, lz = src, src - Ex, src - Ex - Ey

    def ijk(l, d1, d2):
        return l // d1, (l % d1) // d2, l % d2

    xi, xj, xk = ijk(lx, Y * Z, Z)
    yi, yj, yk = ijk(ly, (Y - 1) * Z, Z)
    zi, zj, zk = ijk(lz, Y * (Z - 1), Z - 1)

    def pick(a, b, c):
        return torch.where(is_x, a, torch.where(is_y, b, c))

    i, j, k = pick(xi, yi, zi), pick(xj, yj, zj), pick(xk, yk, zk)
    p0 = i * (Y * Z) + j * Z + k
    p1 = p0 + torch.where(is_x, Y * Z, torch.where(is_y, Z, 1))
    return is_x, is_y, is_z, i, j, k, p0, p1


def _mask_thresh(thresh) -> float:
    """The value of a float or 0-d tensor ``thresh`` for the mask pass."""
    return float(thresh.detach()) if isinstance(thresh, Tensor) else float(
        thresh)


def _thresh_arg(thresh, device: torch.device):
    """``thresh`` for the position math: a float stays a float; a tensor
    goes to ``device`` as a 0-d float32 tensor that keeps its gradient."""
    if not isinstance(thresh, Tensor):
        return float(thresh)
    if thresh.numel() != 1:
        raise ValueError(f"thresh must be a scalar, got shape "
                         f"{tuple(thresh.shape)}")
    return thresh.reshape(()).to(device=device, dtype=torch.float32)


def _tail_index(idx: Tensor, keep: Tensor, n: int) -> Tensor:
    """The add index of :class:`_TailGather`'s backward, shaped as ``idx``
    (rows, ...): ``idx`` on the rows where ``keep`` (rows,) holds, and ``n``
    plus its flat position on every entry of the other rows, past the
    source's ``n`` rows."""
    tail = n + torch.arange(idx.numel(), device=idx.device).view(idx.shape)
    return torch.where(keep.view((-1,) + (1,) * (idx.dim() - 1)), idx, tail)


def _tail_adds(idx: Tensor, keep: Tensor, g: Tensor, n: int) -> Tensor:
    """The backward of ``src[idx]`` for a source of ``n`` rows: one
    ``index_add_`` of the cotangent ``g``, in ``idx``'s row-major order,
    into zero rows at :func:`_tail_index`; the tail that the dropped rows
    add into is cut off."""
    at = _tail_index(idx, keep, n).reshape(-1)
    row = g.shape[idx.dim():]
    out = g.new_zeros((n + at.numel(),) + row)
    out.index_add_(0, at, g.reshape((at.numel(),) + row))
    return out[:n]


class _TailGather(torch.autograd.Function):
    """``src[idx]``, for an index whose rows where ``keep`` is false are
    misses or padding: they gather a real row (the forward's values are
    the plain gather's), and their cotangent is zero, since the caller
    masks their output. The backward (:func:`_tail_adds`) sends each entry
    of such a row to its own slot of a tail past ``src`` and cuts the tail
    off. So the add index is injective over the dropped rows, and each
    real row receives exactly the adds it received with the dropped rows at
    their forward index, in the same order: the gradient keeps its bits but
    for a -0.0 that the dropped rows' +0.0 adds used to turn into +0.0.
    Autograd's index backward sorts the index and sums each run of equal
    indices in one warp, so thousands of dropped rows at one index
    serialise it on the card. On the card ``index_add_`` adds a row's
    several cotangents with atomics, in no fixed order; under
    ``torch.use_deterministic_algorithms(True)`` it sorts and sums them in
    index order, and the tail keeps that sort's runs short.
    """

    @staticmethod
    def forward(ctx, src, idx, keep):
        ctx.save_for_backward(idx, keep)
        ctx.n = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, g):
        idx, keep = ctx.saved_tensors
        return _tail_adds(idx, keep, g, ctx.n), None, None


def _selected_positions(density: Tensor, thresh, src: Tensor,
                        valid: Tensor, scale: Tensor, lower: Tensor
                        ) -> Tensor:
    """World positions (3, capacity) of the selected crossing edges.

    The forward formula of ``_selected_positions_fwd`` in the JAX package:
    decode the edge id, gather its two density samples, interpolate with
    ``dt = clip((thresh - d0) / (d1 - d0), 0, 1)`` (a zero denominator
    divides by 1 instead). ``clamp`` passes the whole gradient at a bound,
    as the JAX package's hand-written VJP does, to the density and to a
    tensor ``thresh`` alike. The padding slots (``valid`` false; ``src`` 0,
    edge 0) gather edge 0's samples, and their zeroed positions give them a
    zero cotangent; the gather's backward adds them past the grid
    (:class:`_TailGather`), not at edge 0's two points.
    """
    is_x, is_y, is_z, i, j, k, p0, p1 = _decode_edge(src, density.shape)
    d0, d1 = _TailGather.apply(density.reshape(-1),
                               torch.stack([p0, p1], 1), valid).unbind(1)
    den = d1 - d0
    safe = torch.where(den == 0, torch.ones_like(den), den)
    dt = torch.clamp((thresh - d0) / safe, 0.0, 1.0)
    zero = torch.zeros_like(dt)
    coords = [i.to(torch.float32) + torch.where(is_x, dt, zero),
              j.to(torch.float32) + torch.where(is_y, dt, zero),
              k.to(torch.float32) + torch.where(is_z, dt, zero)]
    out = torch.stack([coords[a] * scale[a] + lower[a] for a in range(3)])
    return torch.where(valid[None, :], out, torch.zeros_like(out))


def _counts(density: Tensor, thresh) -> Tuple[Tensor, Tensor, Tensor]:
    """(num_vertices, num_faces, active cubes) as 0-d int64 tensors."""
    cx, cy, cz, cm = fused_masks(density, _mask_thresh(thresh))
    num_tris, _ = _tables(density.device)
    nv = (cx.sum(dtype=torch.int64) + cy.sum(dtype=torch.int64)
          + cz.sum(dtype=torch.int64))
    ntris = num_tris[cm.reshape(-1).to(torch.int64)]
    return nv, ntris.sum(dtype=torch.int64), (ntris > 0).sum(dtype=torch.int64)


class _FaceSlots(NamedTuple):
    """Active-cube compaction and the face slot -> (cube, k) decode."""

    num_faces: Tensor  # () int64 true count
    n_active: Tensor  # () int64 true active-cube count
    a_ovf: Tensor  # () bool: more active cubes than the budget
    asrc: Tensor  # (Ac,) flat ids of the active cubes, in order
    valid_a: Tensor  # (Ac,) bool: slot < n_active
    ntris_a: Tensor  # (Ac,) their triangle counts (0 past n_active)
    base_a: Tensor  # (Ac,) first face slot of each active cube
    apos: Tensor  # (Fc,) active cube of each face slot
    k: Tensor  # (Fc,) triangle of the slot within its cube
    cube: Tensor  # (Fc,) flat cube id of each slot
    code: Tensor  # (Fc,) 8-bit corner mask of each slot's cube
    valid_f: Tensor  # (Fc,) bool: slot < num_faces


def _face_slots(cmask: Tensor, face_capacity: int,
                active_capacity: int) -> _FaceSlots:
    """Compact the active cubes (budget ``active_capacity``, 0 = the face
    capacity), then decode every face slot. Slot q belongs to the active
    cube whose inclusive triangle count first exceeds q; slots past the
    total decode to in-bounds garbage that ``valid_f`` masks."""
    dev = cmask.device
    num_tris, _ = _tables(dev)
    mask = cmask.reshape(-1).to(torch.int64)
    ntris = num_tris[mask]
    num_faces = ntris.sum(dtype=torch.int64)
    amask = ntris > 0
    Ac = active_capacity or face_capacity
    asrc = _compact_src(amask, _excl_cumsum(amask), Ac)
    n_active = amask.sum(dtype=torch.int64)
    valid_a = torch.arange(Ac, device=dev) < n_active
    ntris_a = torch.where(valid_a, ntris[asrc].to(torch.int64), 0)
    mask_a = torch.where(valid_a, mask[asrc], 0)
    incl = torch.cumsum(ntris_a, 0)
    base_a = incl - ntris_a
    q = torch.arange(face_capacity, dtype=torch.int64, device=dev)
    apos = torch.searchsorted(incl, q, right=True).clamp_(max=Ac - 1)
    return _FaceSlots(num_faces, n_active, n_active > Ac, asrc, valid_a,
                      ntris_a, base_a, apos, q - base_a[apos], asrc[apos],
                      mask_a[apos], q < num_faces)


def _cube_ijk(cube: Tensor, Y: int, Z: int):
    """Flat cube ids of the (X-1, Y-1, Z-1) cube grid -> (ci, cj, ck)."""
    CY, CZ = Y - 1, Z - 1
    return cube // (CY * CZ), (cube // CZ) % CY, cube % CZ


def _mc_padded_impl(density: Tensor, thresh, lower: Tensor,
                    upper: Tensor, vert_capacity: int, face_capacity: int,
                    active_capacity: int = 0) -> MCResult:
    X, Y, Z = density.shape
    dev = density.device
    _, packed_flat = _tables(dev)
    cx, cy, cz, cmask = fused_masks(density.detach(), _mask_thresh(thresh))

    # --- vertices: select the crossing edges, then positions -------------
    # ONE exclusive scan over the concatenated crossing mask is the global
    # vertex numbering of all three axes (x-edges first, then y, z)
    mask_flat = torch.cat([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)])
    ids_all = _excl_cumsum(mask_flat)
    num_vertices = mask_flat.sum(dtype=torch.int64)
    src = _compact_src(mask_flat.bool(), ids_all, vert_capacity)
    valid_v = torch.arange(vert_capacity, device=dev) < num_vertices
    scale = (upper - lower) / torch.tensor([X, Y, Z], dtype=torch.float32,
                                           device=dev)
    verts = _selected_positions(density, thresh, src, valid_v, scale,
                                lower).T.contiguous()

    # --- faces: compact the active cubes, then slot -> (cube, k) ---------
    fs = _face_slots(cmask, face_capacity, active_capacity)
    ci, cj, ck = _cube_ijk(fs.cube, Y, Z)
    pk = packed_flat[fs.code * MAX_TRIS_PER_CUBE
                     + fs.k.clamp(0, MAX_TRIS_PER_CUBE - 1)].to(torch.int64)
    base_x = (ci * Y + cj) * Z + ck  # x-edge block: (X-1, Y, Z)
    base_y = (ci * (Y - 1) + cj) * Z + ck  # y-edge block: (X, Y-1, Z)
    base_z = (ci * Y + cj) * (Z - 1) + ck  # z-edge block: (X, Y, Z-1)
    Ex = (X - 1) * Y * Z
    Ey = X * (Y - 1) * Z
    fcols = []
    for j in range(3):
        info = (pk >> (5 * j)) & 31
        ax = info >> 3
        ox = (info >> 2) & 1
        oy = (info >> 1) & 1
        oz = info & 1
        fx = base_x + oy * Z + oz
        fy = base_y + ox * ((Y - 1) * Z) + oz
        fz = base_z + ox * (Y * (Z - 1)) + oy * (Z - 1)
        gidx = torch.where(ax == 0, fx,
                           torch.where(ax == 1, Ex + fy, Ex + Ey + fz))
        fcols.append(torch.where(fs.valid_f, ids_all[gidx], 0))
    faces = torch.stack(fcols, dim=-1).to(torch.int32)
    return MCResult(verts, faces, num_vertices.to(torch.int32),
                    fs.num_faces.to(torch.int32), fs.a_ovf)


# --- triangle soup: positions emitted at the face pass ----------------------

# corner (dx, dy, dz) of a cube's 2x2x2 block sits at column dx*4 + dy*2 + dz
_CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


class _CornerGather(torch.autograd.Function):
    """(A, 8) corner densities of the cubes at flat grid indices ``base``.

    Eight flat gathers at active-cube granularity, one per corner; the
    padding slots (``valid`` false) gather cube 0's corners. The backward
    (:func:`_corner_adds`) adds each corner's column into the grid with its
    own ``index_add_``. Within one corner the active cubes' indices are
    distinct, and each padding row, whose cotangent is zero, adds into its
    own slot of a tail past the grid that is cut off: no two adds of a
    column meet, so every run gives the same bits, and no run of equal
    indices serialises the card's atomics (the padding rows all at cube 0
    made each add a run of ~230k adds to one address at the flagship size).
    The generic backward of one (A, 8) gather sorts all 8A indices instead;
    at the 256^3 flagship size it took 27 ms of a 33 ms backward on an H100.
    """

    @staticmethod
    def forward(ctx, density, base, valid):
        _, Y, Z = density.shape
        offs = torch.tensor([(dx * Y + dy) * Z + dz
                             for dx, dy, dz in _CORNERS],
                            dtype=torch.int64, device=density.device)
        idx = base[:, None] + offs
        ctx.save_for_backward(idx, valid)
        ctx.shape = density.shape
        return density.reshape(-1)[idx]

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        return _corner_adds(idx, valid, g, ctx.shape), None, None


def _corner_index(idx: Tensor, valid: Tensor, numel: int) -> Tensor:
    """The backward's (A, 8) add index: ``idx`` on the valid rows, and
    ``numel + a`` on each padding row a, past the grid's ``numel`` points."""
    tail = numel + torch.arange(idx.shape[0], device=idx.device)
    return torch.where(valid[:, None], idx, tail[:, None])


def _corner_adds(idx: Tensor, valid: Tensor, g: Tensor,
                 shape: torch.Size) -> Tensor:
    """The corner gather's backward: the columns of ``g`` (A, 8) added into
    a zero grid of ``shape`` at :func:`_corner_index`, one ``index_add_``
    per corner; the tail the padding rows add into is cut off."""
    numel = shape.numel()
    at = _corner_index(idx, valid, numel)
    dflat = g.new_zeros(numel + idx.shape[0])
    for c in range(8):
        dflat.index_add_(0, at[:, c], g[:, c])
    return dflat[:numel].reshape(shape)


class _SlotRows(torch.autograd.Function):
    """``cd8[apos]`` with a windowed segment-sum backward.

    The face slots of active cube a are ``[base_a[a], base_a[a] +
    ntris_a[a])`` and ``ntris_a <= MAX_TRIS_PER_CUBE``, so the backward sums
    each cube's consecutive cotangent rows with MAX_TRIS_PER_CUBE masked row
    gathers instead of a scatter over all face slots.
    """

    @staticmethod
    def forward(ctx, cd8, apos, base_a, ntris_a):
        ctx.save_for_backward(base_a, ntris_a)
        return cd8[apos]

    @staticmethod
    def backward(ctx, g):
        base_a, ntris_a = ctx.saved_tensors
        F = g.shape[0]
        dcd8 = torch.zeros((base_a.shape[0],) + g.shape[1:], dtype=g.dtype,
                           device=g.device)
        for t in range(MAX_TRIS_PER_CUBE):
            rows = g[(base_a + t).clamp(0, F - 1)]
            dcd8 = dcd8 + torch.where((t < ntris_a)[:, None], rows, 0.0)
        return dcd8, None, None, None


def _select8(rows: Tensor, code: Tensor) -> Tensor:
    """``rows[:, code]`` per row, as a static 8-way select chain."""
    out = rows[:, 0]
    for i in range(1, 8):
        out = torch.where(code == i, rows[:, i], out)
    return out


class MCSoupResult(NamedTuple):
    """Padded triangle-soup marching cubes output (fixed shapes).

    ``soup[:num_faces]`` are world-space triangles; the tail is zero padding
    (point triangles, which the casters never hit). The fields and defaults
    are the JAX package's.
    """

    soup: Tensor  # (face_capacity, 3, 3) float32
    num_faces: Tensor  # () int32 (true count, may exceed capacity)
    # () bool: the active-cube budget ran out (or False, as in the JAX type)
    active_overflow: Union[Tensor, bool] = False

    @property
    def overflowed(self) -> Tensor:
        return (self.num_faces > self.soup.shape[0]) | self.active_overflow


def _mc_soup_impl(density: Tensor, thresh, lower: Tensor,
                  upper: Tensor, face_capacity: int,
                  active_capacity: int = 0, row_limit: Optional[int] = None,
                  x_offset: int = 0, x_total: int = 0
                  ) -> Tuple[MCSoupResult, Tensor]:
    """Triangle-soup marching cubes, differentiable with respect to density.

    Each face slot decodes its three edges from the cube coordinates and the
    packed triangle table and interpolates the crossings from the cube's
    eight corner densities, so no vertex numbering is built. Gradients reach
    the grid through the corner gather. Returns the result and the active
    cubes counted (() int32), which the overflow checks name.

    Shard-window mode (``parallel/pipeline.py``): ``density`` is an x-slab
    of a larger grid plus one halo row; ``row_limit`` masks the cube rows
    at and past the end of the shard's owned range, ``x_offset`` is the
    slab's first global x index (positions come out in the whole grid's
    world space) and ``x_total`` the whole grid's x extent (the world
    scale). Unset, the call is the single-grid one, bit for bit.
    """
    X, Y, Z = density.shape
    dev = density.device
    _, packed_flat = _tables(dev)
    _, _, _, cmask = fused_masks(density.detach(), _mask_thresh(thresh))
    if row_limit is not None:
        cmask[max(int(row_limit), 0):] = 0
    scale = (upper - lower) / torch.tensor([x_total or X, Y, Z],
                                           dtype=torch.float32, device=dev)
    fs = _face_slots(cmask, face_capacity, active_capacity)
    ci, cj, ck = _cube_ijk(fs.cube, Y, Z)
    if x_offset:
        ci = ci + int(x_offset)  # global x of the slab's cube rows
    pk = packed_flat[fs.code * MAX_TRIS_PER_CUBE
                     + fs.k.clamp(0, MAX_TRIS_PER_CUBE - 1)].to(torch.int64)
    # corner densities: one gather per active cube, one row per face slot;
    # every edge endpoint is one of the cube's 8 corners
    ci_a, cj_a, ck_a = _cube_ijk(fs.asrc, Y, Z)
    cd = _CornerGather.apply(density, (ci_a * Y + cj_a) * Z + ck_a,
                             fs.valid_a)
    cd8 = _SlotRows.apply(cd, fs.apos, fs.base_a, fs.ntris_a)
    zero = density.new_zeros(())
    one = density.new_ones(())
    corners = []
    for j in range(3):
        info = (pk >> (5 * j)) & 31
        ax = info >> 3
        # edge lattice start: x-edges at (ci, cj+oy, ck+oz), y-edges at
        # (ci+ox, cj, ck+oz), z-edges at (ci+ox, cj+oy, ck)
        d0xyz = [torch.where(ax == a, 0, (info >> (2 - a)) & 1)
                 for a in range(3)]
        code0 = d0xyz[0] * 4 + d0xyz[1] * 2 + d0xyz[2]
        code1 = code0 + torch.where(ax == 0, 4, torch.where(ax == 1, 2, 1))
        d0 = _select8(cd8, code0)
        d1 = _select8(cd8, code1)
        den = d1 - d0
        safe = torch.where(den == 0, one, den)
        # min(max(., 0), 1) and not clamp: JAX's clip gives half the
        # gradient where the ratio is exactly 0 or 1, and so do these
        dt = torch.minimum(torch.maximum((thresh - d0) / safe, zero), one)
        vtx = torch.stack(
            [((c + d0xyz[a]).to(torch.float32)
              + torch.where(ax == a, dt, zero)) * scale[a] + lower[a]
             for a, c in enumerate((ci, cj, ck))], dim=-1)
        corners.append(torch.where(fs.valid_f[:, None], vtx, zero))
    soup = torch.stack(corners, dim=1)  # (Fc, 3, 3)
    return (MCSoupResult(soup, fs.num_faces.to(torch.int32), fs.a_ovf),
            fs.n_active.to(torch.int32))


def _density_tensor(density, device: torch.device) -> Tensor:
    d = as_tensor(density, torch.float32, device).contiguous()
    if d.dim() != 3 or min(d.shape) < 2:
        raise ValueError(
            f"density must be a 3-D grid with every dim >= 2, got "
            f"{tuple(d.shape)}")
    return d


def marching_cubes_counts(density, thresh: ThreshLike,
                          device: DeviceLike = "cuda") -> Tuple[Tensor, Tensor]:
    """(num_vertices, num_faces) as 0-d int32 tensors, without a host sync
    (but for the read of a tensor ``thresh`` on the card)."""
    dev = resolve_device(device)
    nv, nf, _ = _counts(_density_tensor(density, dev), thresh)
    return nv.to(torch.int32), nf.to(torch.int32)


def marching_cubes_padded(
    density,
    thresh: ThreshLike,
    *,
    vert_capacity: Optional[int] = None,
    face_capacity: Optional[int] = None,
    lower=None,
    upper=None,
    vert_units: int = 0,
    cube_units: int = 0,
    active_capacity: int = 0,
    config=None,
    device: DeviceLike = "cuda",
) -> MCResult:
    """Marching cubes with fixed-capacity outputs and no host sync.

    Capacities may come from a :class:`core.config.MarchingCubesConfig` via
    ``config``; explicit arguments override it. ``vert_units`` and
    ``cube_units`` are accepted and unused, as in the JAX package (its
    selection has needed no unit budget since its round 5).
    """
    del vert_units, cube_units
    if config is not None:
        if vert_capacity is None:
            vert_capacity = config.vert_capacity
        if face_capacity is None:
            face_capacity = config.face_capacity
        active_capacity = active_capacity or config.active_capacity
    if vert_capacity is None or face_capacity is None:
        raise ValueError(
            "vert_capacity/face_capacity required (directly or via config)")
    dev = resolve_device(device)
    d = _density_tensor(density, dev)
    X, Y, Z = d.shape
    lo = as_tensor([0.0, 0.0, 0.0] if lower is None else lower,
                   torch.float32, dev)
    up = as_tensor([X, Y, Z] if upper is None else upper, torch.float32, dev)
    res = _mc_padded_impl(d, _thresh_arg(thresh, dev), lo, up,
                          int(vert_capacity),
                          int(face_capacity), int(active_capacity))
    debug.check(
        ~res.overflowed,
        "marching_cubes_padded: capacity overflow "
        "(counted {v} verts / {f} faces)",
        v=res.num_vertices, f=res.num_faces,
    )
    return res


def marching_cubes_soup(
    density,
    thresh: ThreshLike,
    *,
    face_capacity: int,
    lower=None,
    upper=None,
    active_capacity: int = 0,
    device: DeviceLike = "cuda",
) -> MCSoupResult:
    """Differentiable triangle-soup marching cubes with no host sync.

    The same triangles, in the same order, as
    ``marching_cubes_padded(...).vertices[faces]``, without building the
    indexed mesh. ``density`` goes to ``device``; the gradient reaches a
    tensor input wherever it lies. Inside ``debug.checks()`` an overflow
    raises and names the budget that ran out.
    """
    dev = resolve_device(device)
    d = _density_tensor(density, dev)
    X, Y, Z = d.shape
    lo = as_tensor([0.0, 0.0, 0.0] if lower is None else lower,
                   torch.float32, dev)
    up = as_tensor([X, Y, Z] if upper is None else upper, torch.float32, dev)
    res, n_active = _mc_soup_impl(d, _thresh_arg(thresh, dev), lo, up,
                                  int(face_capacity), int(active_capacity))
    debug.check(res.num_faces <= face_capacity,
                "marching_cubes_soup: face_capacity {c} overflowed "
                "(counted {f} faces)", c=int(face_capacity), f=res.num_faces)
    debug.check(~res.active_overflow,
                "marching_cubes_soup: active_capacity {c} overflowed "
                "(counted {a} active cubes)",
                c=int(active_capacity or face_capacity), a=n_active)
    return res


def _round_capacity(n: int) -> int:
    """Round up to the next power of two (at least 16)."""
    n = max(int(n), 16)
    return 1 << (n - 1).bit_length()


def marching_cubes(
    density,
    thresh: ThreshLike,
    scale: Optional[ScaleLike] = None,
    verbose: bool = False,
    cpu: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[Tensor, Tensor]:
    """Eager marching cubes: exact-size (vertices, faces).

    ``scale`` is normalised to a bbox by ``core.grid.resolve_bounds``;
    returns float32 world-space vertices and int32 faces. One device->host
    sync reads the counts, then the padded extraction runs and is trimmed.
    ``cpu=True`` runs on the host CPU (the same as ``device="cpu"``).
    """
    dev = resolve_device("cpu" if cpu else device)
    d = _density_tensor(density, dev)
    lower, upper = resolve_bounds(tuple(d.shape), scale)
    nvt, nft, nat = _counts(d, thresh)
    nv, nf, na = torch.stack([nvt, nft, nat]).tolist()
    res = marching_cubes_padded(
        d, thresh,
        vert_capacity=_round_capacity(nv),
        face_capacity=_round_capacity(nf),
        lower=lower, upper=upper,
        active_capacity=_round_capacity(na),
        device=dev,
    )
    if verbose:
        print(f"#vertices={nv}")
        print(f"#triangles={nf}")
    return res.vertices[:nv], res.faces[:nf]
