"""Sharded SDF-fitting loss: x-slab extraction and data-parallel rays.

Counterpart of ``primitive3d_tpu/parallel/pipeline.py``. One mesh axis
carries both decompositions of the differentiable SDF -> mesh -> depth
step (``pipeline.py``):

  * the density grid is split into x-slabs; each rank extracts a triangle
    soup from its slab plus a 1-row +x halo (``_mc_soup_impl`` in
    shard-window mode). A soup has no vertex ids, so the extraction needs
    no distributed scan, only the halo;
  * the per-rank soups are all-gathered (differentiable) and every rank
    builds the identity-order clusters of the whole soup;
  * each rank casts its slice of the rays (``cast_clusters_diff``) and
    sums its squared depth errors; the loss is the sum over ranks / R.

On the card the path launches ``mc_masks`` on the rank's slab,
``stream_cull``, the cast kernels and, in the backward, ``plane_scatter``.
"""
from __future__ import annotations

import torch

from ..core import debug
from ..core.device import as_tensor
from ..kernels.raycast_kernel import cast_clusters_diff
from ..ops.marching_cubes import _mc_soup_impl, _thresh_arg
from .mesh import (Mesh, all_gather, gather_rows, halo_rows, psum,
                   sharded_along)

Tensor = torch.Tensor


def sharded_sdf_fitting_loss(
    mesh: Mesh,
    density,
    origins,
    dirs,
    target_depth,
    axis_name: str = "data",
    *,
    thresh=0.0,
    vert_capacity: int = 0,
    face_capacity: int,
    lower=None,
    upper=None,
    max_dist: float = 10.0,
    vert_units: int = 0,
    cube_units: int = 0,
    mxu_max_tris=None,
    mxu_stream_max_tris=None,
    backend: str = "pallas",
    active_capacity: int = 0,
    chunk: int = 512,
) -> Tensor:
    """L2 depth-matching loss, extraction-sharded and ray-sharded.

    Every rank calls it with the whole ``density``, rays and target, and
    gets the whole loss, the mean over all R rays as in
    ``pipeline.sdf_fitting_loss``; ``loss.backward()`` on every rank gives
    ``density`` its whole gradient, the same on every rank.
    ``face_capacity`` is global: each rank gets ``fcap = ceil(
    face_capacity / (S * 128)) * 128`` faces, so it must bound the worst
    slab's load times S. ``active_capacity`` is the global active-cube
    bound, which holds on every slab, so the per-rank budget is ``acap =
    min(fcap, ceil(active_capacity / 128) * 128)``, not divided by S.
    Inside ``debug.checks()`` a rank that overflows either budget raises on
    every rank, naming the budget. The ray count must divide the axis size.
    ``vert_capacity``, ``vert_units``, ``cube_units`` and ``chunk`` are
    accepted and unused, as in the JAX package (the soup has no vertex
    stage).
    """
    del vert_capacity, vert_units, cube_units, chunk
    if backend != "pallas":
        raise ValueError(
            "sharded_sdf_fitting_loss only implements the pallas cast path; "
            f"got backend={backend!r} (use pipeline.sdf_fitting_loss for "
            "other backends)")
    S = mesh.shape[axis_name]
    s = mesh.rank
    dev = mesh.device
    density = as_tensor(density, torch.float32, dev)
    o = as_tensor(origins, torch.float32, dev).reshape(-1, 3)
    d = as_tensor(dirs, torch.float32, dev).reshape(-1, 3)
    t = as_tensor(target_depth, torch.float32, dev).reshape(-1)
    R = o.shape[0]
    if R % S:
        raise ValueError(f"the ray count {R} must divide by the axis size "
                         f"{S}")
    X, Y, Z = density.shape
    fcap = -(-face_capacity // (S * 128)) * 128
    acap = (min(fcap, -(-active_capacity // 128) * 128) if active_capacity
            else fcap)
    lo_w = as_tensor([0.0, 0.0, 0.0] if lower is None else lower,
                     torch.float32, dev)
    up_w = as_tensor([X, Y, Z] if upper is None else upper, torch.float32,
                     dev)

    # this rank's slab (X padded with edge rows) and a 1-row +x halo; the
    # last rank takes its own last row, so no cube reaches past the grid
    slab = sharded_along(mesh, density)
    Xs = slab.shape[0]
    g = torch.cat([slab, halo_rows(mesh, slab, 1)])  # (Xs + 1, Y, Z)
    # owned cube rows: global [s * Xs, min((s + 1) * Xs, X - 1))
    sres, n_active = _mc_soup_impl(
        g, _thresh_arg(thresh, dev), lo_w, up_w, fcap, acap,
        row_limit=min(max(X - 1 - s * Xs, 0), Xs), x_offset=s * Xs,
        x_total=X)
    if debug.enabled():
        counts = gather_rows(mesh, torch.stack(
            [sres.num_faces, n_active]).to(torch.int64)[None])
        for r, (nf, na) in enumerate(counts.tolist()):
            debug.check(nf <= fcap, "sharded_sdf_fitting_loss: shard {r} "
                        "counted {f} faces, past its face capacity fcap = "
                        "{c}", r=r, f=nf, c=fcap)
            debug.check(na <= acap, "sharded_sdf_fitting_loss: shard {r} "
                        "counted {a} active cubes, past its active capacity "
                        "acap = {c}", r=r, a=na, c=acap)
    soup = all_gather(mesh, sres.soup)  # (S * fcap, 3, 3), x-slab order
    n = R // S
    depth, _ = cast_clusters_diff(
        soup, o[s * n:(s + 1) * n], d[s * n:(s + 1) * n], max_dist=max_dist,
        mxu_max_tris=mxu_max_tris, mxu_stream_max_tris=mxu_stream_max_tris)
    return psum(mesh, torch.sum((depth - t[s * n:(s + 1) * n]) ** 2)) / R
