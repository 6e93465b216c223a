"""primitive3d_tpu_torch — the PyTorch/CUDA port of primitive3d_tpu.

The JAX package (``primitive3d_tpu``) stays as the reference; this package
runs beside it on an NVIDIA Hopper card, with every TPU kernel on its path
rewritten by hand in CUDA C++ (``csrc/``). It never imports JAX or the JAX
package.

Its first slice covers the serving path of the library's quick start:

    import numpy as np
    import primitive3d_tpu_torch as p3t
    from primitive3d_tpu_torch.render.camera import camera_rays

    v, f = p3t.marching_cubes(np.load("bunny.npy"), 0.0, scale=1.0)
    rc = p3t.create_raycaster(v, f, backend="pallas")
    cam = camera_rays(512, 512, origin=(0.5, 0.5, -1.5),
                      look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    hits = rc.cast(cam.origins, cam.dirs)      # depth, normals, face_id

and its second slice adds the training path, one differentiable
SDF-fitting step (soup marching cubes -> cluster cast -> L2 depth loss ->
gradient to the grid):

    density = torch.from_numpy(grid).cuda().requires_grad_()
    loss = p3t.sdf_fitting_loss(density, cam.origins, cam.dirs, target,
                                vert_capacity=262_144, face_capacity=425_984,
                                lower=(-1, -1, -1), upper=(1, 1, 1),
                                backend="pallas")
    loss.backward()

The third slice adds the cluster caster's scalar-broadcast tier, which
``create_raycaster`` takes by itself for meshes past 32767 clusters (a
photogrammetry or LiDAR mesh of tens of millions of triangles), and the
other backends of the JAX package: ``"mxu"``, ``"bruteforce"`` and
``"bvh"``.

The ninth slice adds the rest of the JAX package's top-level API:
differentiable marching tetrahedra (the sort tier for any tet mesh and the
sort-free tier for the Kuhn lattice of ``grid_tetrahedra``), PLY export and
import, and ``__version__``; beside them ``native`` (the ctypes binding of
the host runtime), ``geometry.aabb``, ``core.canonical`` and
``core.profiling``:

    v, f, tet_idx = p3t.marching_tetrahedra(points, tets, sdf,
                                            return_tet_idx=True)
    p3t.save_mesh(v, f, filename="mesh.ply")

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"`` (or ``cpu=True`` to ``marching_cubes``); without a card
they raise.
"""
from .core.config import Config, MarchingCubesConfig, RayCastConfig
from .core.grid import scale_to_bound
from .core.timer import Timer, TimerError, time_fn
from .io.ply import load_mesh, save_mesh
from .ops.marching_cubes import (
    MCResult,
    MCSoupResult,
    marching_cubes,
    marching_cubes_counts,
    marching_cubes_padded,
    marching_cubes_soup,
)
from .ops.marching_tetrahedra import (
    MTResult,
    grid_tetrahedra,
    marching_tetrahedra,
    marching_tetrahedra_lattice,
    marching_tetrahedra_padded,
)
from .pipeline import RenderOut, render_depth, sdf_fitting_loss
from .raycast import RayHits, available_backends, create_raycaster
from .version import __version__

# the reference library's spelling
marching_tetrahedras = marching_tetrahedra

__all__ = [
    "__version__",
    "Config",
    "RayCastConfig",
    "MarchingCubesConfig",
    "RayHits",
    "available_backends",
    "create_raycaster",
    "Timer",
    "TimerError",
    "time_fn",
    "scale_to_bound",
    "save_mesh",
    "load_mesh",
    "MCResult",
    "marching_cubes",
    "marching_cubes_counts",
    "marching_cubes_padded",
    "MCSoupResult",
    "marching_cubes_soup",
    "RenderOut",
    "render_depth",
    "sdf_fitting_loss",
    "MTResult",
    "grid_tetrahedra",
    "marching_tetrahedra",
    "marching_tetrahedras",
    "marching_tetrahedra_lattice",
    "marching_tetrahedra_padded",
]
