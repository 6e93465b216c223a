"""Marching cubes over x-slabs of the grid, one slab per rank.

Counterpart of ``primitive3d_tpu/parallel/marching_cubes.py``. Each rank
takes its x-slab of the grid and the first row of the next slab (the +x
halo), and numbers vertices and faces globally, with no id given twice:

  * vertices are numbered row-major: point row i owns the contiguous block
    ``[y-edge crossings(i), z-edge crossings(i), x-edge crossings(i)]``.
    The order y, z, x lets a rank compute the ids of its halo row's y and z
    crossings from the halo row alone, and those are the only foreign ids
    its seam cubes reference, so a seam vertex gets the same id on both
    sides;
  * per-row counts are all-gathered and exclusive-scanned alike on every
    rank;
  * each rank owns a contiguous range of ids, so the per-rank padded
    buffers concatenate into the global padded result.

The masks come from ``kernels.mc_masks.fused_masks`` on the (Xs + 1, Y, Z)
slab: the ``mc_masks`` kernel on the card, its plain version on the CPU.
The selections are the single-device op's exact first-``cap`` ones.
Differentiable with respect to the density.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import debug
from ..core.device import as_tensor
from ..kernels.mc_masks import fused_masks
from ..ops.marching_cubes import (MAX_TRIS_PER_CUBE, _compact_src,
                                  _cube_ijk, _excl_cumsum, _face_slots,
                                  _mask_thresh, _tables, _TailGather,
                                  _thresh_arg)
from .mesh import Mesh, gather_rows, gather_shards, halo_rows, sharded_along

Tensor = torch.Tensor


class ShardedMCResult(NamedTuple):
    """Per-shard padded outputs, whole on every rank; concatenating the
    shards' valid windows gives the global mesh. ``vert_base`` and
    ``face_base`` are each shard's global id offsets, ``vert_count`` and
    ``face_count`` its true counts, which may exceed the per-shard
    capacities: check :attr:`overflowed` before trusting the buffers."""

    vertices: Tensor  # (S * vert_cap_per_shard, 3) float32
    faces: Tensor  # (S * face_cap_per_shard, 3) int32
    vert_base: Tensor  # (S,) int32
    face_base: Tensor  # (S,) int32
    vert_count: Tensor  # (S,) int32
    face_count: Tensor  # (S,) int32

    @property
    def overflowed(self) -> Tensor:
        S = self.vert_base.shape[0]
        vcap = self.vertices.shape[0] // S
        fcap = self.faces.shape[0] // S
        return torch.any((self.vert_count > vcap) | (self.face_count > fcap))


def _row_ids(c: Tensor) -> Tensor:
    """Exclusive within-row ranks of a (rows, ...) 0/1 tensor, int64."""
    flat = c.reshape(c.shape[0], -1).to(torch.int64)
    return (torch.cumsum(flat, 1) - flat).reshape(c.shape)


def _shard_outputs(mesh: Mesh, out) -> Tuple[Tensor, ...]:
    """The per-rank outputs of a shard body, whole on every rank."""
    verts, faces, vb, fb, vc, fc = out
    counts = gather_rows(mesh, torch.stack([vb, fb, vc, fc])[None])
    return (gather_shards(mesh, verts), gather_rows(mesh, faces),
            *(counts[:, i].to(torch.int32) for i in range(4)))


def sharded_marching_cubes(
    mesh: Mesh,
    density,
    thresh,
    *,
    vert_cap_per_shard: int,
    face_cap_per_shard: int,
    axis_name: str = "x",
    vert_units: int = 0,
    cube_units: int = 0,
) -> ShardedMCResult:
    """Marching cubes over an x-sharded grid; every rank calls it with the
    whole (X, Y, Z) ``density`` and gets the whole result.

    An X that the mesh does not divide is padded with copies of the last
    row, whose crossings and cubes are masked against the true row count,
    so any grid runs on any mesh. Vertices are in index space (scale them
    outside). ``vert_units`` and ``cube_units`` are accepted and unused,
    as in the JAX package.
    """
    S = mesh.shape[axis_name]
    density = as_tensor(density, torch.float32, mesh.device)
    slab = sharded_along(mesh, density)
    out = mc_shard_body(
        slab, thresh=thresh, mesh=mesh, S=S, Xv=density.shape[0],
        vert_cap_per_shard=int(vert_cap_per_shard),
        face_cap_per_shard=int(face_cap_per_shard),
        vert_units=vert_units, cube_units=cube_units)
    return _checked(ShardedMCResult(*_shard_outputs(mesh, out)),
                    "sharded_marching_cubes")


def _checked(res: ShardedMCResult, name: str) -> ShardedMCResult:
    """Inside ``debug.checks()``, raise on every rank alike (the counts are
    whole on every rank) if a shard overflowed its capacities."""
    if debug.enabled():
        S = res.vert_base.shape[0]
        vcap, fcap = res.vertices.shape[0] // S, res.faces.shape[0] // S
        for r, (v, f) in enumerate(zip(res.vert_count.tolist(),
                                       res.face_count.tolist())):
            debug.check(v <= vcap and f <= fcap,
                        name + ": per-shard capacity overflow (shard {r} "
                        "counted {v} verts / {f} faces)", r=r, v=v, f=f)
    return res


def mc_shard_body(slab: Tensor, *, thresh, mesh: Mesh, S: int, Xv: int,
                  vert_cap_per_shard: int, face_cap_per_shard: int,
                  vert_units: int = 0, cube_units: int = 0):
    """This rank's part of :func:`sharded_marching_cubes`, for sharded
    programs that compose it. ``slab`` is the rank's (Xs, Y, Z) x-slab of
    the padded grid, whose true row count is ``Xv``. Returns this rank's
    ``(verts, faces, vert_base, face_base, vert_count, face_count)``, the
    last four 0-d int64, with faces holding global vertex ids.
    """
    del vert_units, cube_units  # the selections are exact
    Xs, Y, Z = slab.shape
    s = mesh.rank
    dev = slab.device
    _, packed_flat = _tables(dev)
    g = torch.cat([slab, halo_rows(mesh, slab, 1)])  # (Xs + 1, Y, Z)
    grow = s * Xs + torch.arange(Xs + 1, device=dev)  # global row
    rows_ok = (grow < Xv)[:, None, None]

    # crossings: y and z include the halo row, x the owned rows only; rows
    # past the true grid are edge-row copies and are masked
    cx, cy, cz, cmask = fused_masks(g.detach(), _mask_thresh(thresh))
    cy = cy.bool() & rows_ok
    cz = cz.bool() & rows_ok
    cx = cx.bool() & rows_ok[:Xs]

    # --- one row-major edge layout: per point row [y | z | x] -------------
    nyr, nzr = (Y - 1) * Z, Y * (Z - 1)
    rowlen = nyr + nzr + Y * Z
    crow = torch.cat([
        cy.reshape(Xs + 1, -1), cz.reshape(Xs + 1, -1),
        torch.cat([cx.reshape(Xs, -1),
                   torch.zeros((1, Y * Z), dtype=torch.bool, device=dev)]),
    ], 1).to(torch.int64)  # (Xs + 1, rowlen)

    # --- global per-row offsets: all-gather and exclusive scan -------------
    row_tot_all = gather_rows(mesh, crow[:Xs].sum(1))  # (Xp,)
    row_off = torch.cumsum(row_tot_all, 0) - row_tot_all
    total_v = row_tot_all.sum()
    off = row_off[grow.clamp(max=Xv - 1)]
    off = torch.where(grow > Xv - 1, total_v, off)  # past the grid: no ids
    ids_full = (off[:, None] + _row_ids(crow)).reshape(-1)
    vbase = off[0]

    # --- owned vertices in id order: select, decode, interpolate ----------
    mask_flat = crow[:Xs].reshape(-1)
    src = _compact_src(mask_flat.bool(), _excl_cumsum(mask_flat),
                       vert_cap_per_shard)
    i, r = src // rowlen, src % rowlen
    is_y = r < nyr
    is_z = ~is_y & (r < nyr + nzr)
    is_x = r >= nyr + nzr
    rz, rx = r - nyr, r - nyr - nzr
    j = torch.where(is_y, r // Z, torch.where(is_z, rz // (Z - 1), rx // Z))
    k = torch.where(is_y, r % Z, torch.where(is_z, rz % (Z - 1), rx % Z))
    base = (i * Y + j) * Z + k
    step = torch.where(is_y, Z, torch.where(is_z, 1, Y * Z))
    vcount = mask_flat.sum()  # this shard's rows of row_tot_all
    valid_v = torch.arange(vert_cap_per_shard, device=dev) < vcount
    # x-edges of the last owned row read the halo; the padding slots (src
    # 0) read points 0 and Z, with a zero cotangent (their zeroed
    # positions), which the backward adds past the slab (_TailGather)
    d0, d1 = _TailGather.apply(g.reshape(-1),
                               torch.stack([base, base + step], 1),
                               valid_v).unbind(1)
    den = d1 - d0
    th = _thresh_arg(thresh, dev)
    zero, one = torch.zeros_like(den), torch.ones_like(den)
    # min(max(., 0), 1): JAX's clip, half the gradient at a bound
    dt = torch.minimum(torch.maximum(
        (th - d0) / torch.where(den == 0, one, den), zero), one)
    pos = torch.stack([(i + s * Xs).to(torch.float32)
                       + torch.where(is_x, dt, zero),
                       j.to(torch.float32) + torch.where(is_y, dt, zero),
                       k.to(torch.float32) + torch.where(is_z, dt, zero)], -1)
    verts = torch.where(valid_v[:, None], pos, torch.zeros_like(pos))

    # --- faces: owned cube rows whose +x row lies inside the grid ---------
    m = torch.where((grow[:Xs] < Xv - 1)[:, None, None], cmask,
                    torch.zeros_like(cmask))
    num_tris, _ = _tables(dev)
    row_f_all = gather_rows(mesh, num_tris[m.to(torch.int64)].reshape(
        Xs, -1).sum(1, dtype=torch.int64))
    frow_off = torch.cumsum(row_f_all, 0) - row_f_all
    # rows from Xv - 1 on have no cubes, so a shard past the grid starts at
    # the total
    fbase = frow_off[min(s * Xs, Xv - 1)]

    fs = _face_slots(m, face_cap_per_shard, 0)
    ci, cj, ck = _cube_ijk(fs.cube, Y, Z)
    pk = packed_flat[fs.code * MAX_TRIS_PER_CUBE
                     + fs.k.clamp(0, MAX_TRIS_PER_CUBE - 1)].to(torch.int64)
    fcols = []
    for c in range(3):
        info = (pk >> (5 * c)) & 31
        ax = info >> 3
        ox, oy, oz = (info >> 2) & 1, (info >> 1) & 1, info & 1
        # positions in the per-row [y | z | x] edge layout
        fy = (ci + ox) * rowlen + cj * Z + (ck + oz)
        fz = (ci + ox) * rowlen + nyr + (cj + oy) * (Z - 1) + ck
        fx = ci * rowlen + nyr + nzr + (cj + oy) * Z + (ck + oz)
        gidx = torch.where(ax == 0, fx, torch.where(ax == 1, fy, fz))
        fcols.append(torch.where(fs.valid_f, ids_full[gidx], 0))
    faces = torch.stack(fcols, -1).to(torch.int32)
    return verts, faces, vbase, fbase, vcount, fs.num_faces


def gather_sharded_mesh(res: ShardedMCResult) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """Host-side compaction of a sharded result into exact-size arrays."""
    S = res.vert_base.shape[0]
    v = res.vertices.detach().cpu().numpy().reshape(S, -1, 3)
    f = res.faces.cpu().numpy().reshape(S, -1, 3)
    vn = res.vert_count.cpu().numpy()
    fn = res.face_count.cpu().numpy()
    return (np.concatenate([v[s, :vn[s]] for s in range(S)]),
            np.concatenate([f[s, :fn[s]] for s in range(S)]))
