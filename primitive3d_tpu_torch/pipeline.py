"""Differentiable SDF -> mesh -> depth render, and the SDF-fitting loss.

Counterpart of ``primitive3d_tpu/pipeline.py`` (single device):

    density grid --(marching cubes)--> padded mesh or triangle soup
                 --(ray cast)--> depth, hit
                 --(L2 against a target depth)--> loss

Gradients reach the density grid through the extracted vertex positions and
through the hit triangles' planes. ``backend="pallas"`` extracts a soup
(``marching_cubes_soup``) and casts it with ``cast_clusters_diff`` on the
cluster kernels (whose stream-tier backward is the plane scatter kernel,
and which takes the scalar-broadcast tier past 32767 clusters of 128);
``backend="mxu"`` extracts the indexed mesh and casts every ray against
every triangle (``mxu_cast.cast_mxu``). ``"auto"`` takes ``"pallas"`` above
8192 faces of capacity, as the JAX package does.

The density, rays and target go to ``device`` (the card by default); a
tensor density moves with ``.to``, so its gradient reaches it wherever it
lies.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .core.device import DeviceLike, as_tensor, resolve_device
from .kernels.raycast_kernel import cast_clusters_diff
from .mxu_cast import cast_mxu, triangle_matrix
from .ops.marching_cubes import (MCResult, _TailGather,
                                 marching_cubes_padded, marching_cubes_soup)

Tensor = torch.Tensor


class RenderOut(NamedTuple):
    depth: Tensor  # (R,) float32; max_dist where no surface is hit
    hit: Tensor  # (R,) bool
    # the indexed mesh of the "mxu" backend; None on the "pallas" path,
    # which extracts a soup and builds no indexed mesh
    mc: Optional[MCResult] = None


def render_depth(
    density,
    origins,
    dirs,
    *,
    thresh=0.0,
    vert_capacity: int,
    face_capacity: int,
    lower=None,
    upper=None,
    vert_units: int = 0,
    cube_units: int = 0,
    active_capacity: int = 0,
    max_dist: float = 10.0,
    chunk: int = 512,
    backend: str = "auto",
    device: DeviceLike = "cuda",
) -> RenderOut:
    """Differentiable depth render of the ``thresh`` isosurface of
    ``density`` at fixed capacities.

    ``thresh`` is a float or a 0-d tensor, which then gets a gradient.
    ``chunk`` is the "mxu" backend's triangles per matrix product.
    ``vert_units`` and ``cube_units`` are accepted and unused, as in the JAX
    package.
    """
    del vert_units, cube_units
    if backend == "auto":
        backend = "pallas" if face_capacity > 8192 else "mxu"
    if backend not in ("pallas", "mxu"):
        raise ValueError(f"unknown backend: {backend!r}")
    dev = resolve_device(device)
    o = as_tensor(origins, torch.float32, dev).reshape(-1, 3)
    d = as_tensor(dirs, torch.float32, dev).reshape(-1, 3)
    if backend == "pallas":
        sres = marching_cubes_soup(
            density, thresh, face_capacity=face_capacity, lower=lower,
            upper=upper, active_capacity=active_capacity, device=dev)
        depth, idx = cast_clusters_diff(sres.soup, o, d, max_dist=max_dist)
        return RenderOut(depth, idx >= 0, None)
    res = marching_cubes_padded(
        density, thresh, vert_capacity=vert_capacity,
        face_capacity=face_capacity, lower=lower, upper=upper,
        active_capacity=active_capacity, device=dev)
    # padded faces [0, 0, 0] are point triangles: zero matrices, never hit,
    # so their cotangent is zero; the de-index's backward adds their rows
    # past the vertices (_TailGather), not at vertex 0
    fc = res.faces.shape[0]
    tris = _TailGather.apply(
        res.vertices, res.faces.to(torch.int64),
        torch.arange(fc, device=res.faces.device) < res.num_faces
    )  # (face_capacity, 3, 3)
    depth, idx = cast_mxu(triangle_matrix(tris), o, d, max_dist, chunk)
    return RenderOut(depth, idx >= 0, res)


def sdf_fitting_loss(density, origins, dirs, target_depth, **kwargs
                     ) -> Tensor:
    """Mean squared depth error of :func:`render_depth`: the SDF-fitting
    objective."""
    out = render_depth(density, origins, dirs, **kwargs)
    target = as_tensor(target_depth, torch.float32, out.depth.device)
    return torch.mean((out.depth - target.reshape(-1)) ** 2)
