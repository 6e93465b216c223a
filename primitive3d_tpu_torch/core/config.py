"""Runtime configuration (dataclasses), consumed by the factories.

    cfg = Config(raycast=RayCastConfig(edge_wildcard=True))
    rc = create_raycaster(v, f, config=cfg.raycast)
    res = marching_cubes_padded(grid, 0.0, config=cfg.marching_cubes)

Explicit keyword arguments always override config fields. Counterpart of
``primitive3d_tpu/core/config.py``, with the same fields and defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# the resident tier's default cap in triangles: RayCastConfig,
# raycast.ClusterRayCaster.MXU_MAX_TRIS and, through it,
# kernels.raycast_kernel.cast_clusters_diff read this one number
MXU_MAX_TRIS = 32_000


@dataclasses.dataclass(frozen=True)
class RayCastConfig:
    # "auto" and "pallas" both name the cluster kernels (raycast.py)
    backend: str = "auto"  # auto | pallas | mxu | bvh | bruteforce
    max_dist: float = 10.0
    cluster_size: Optional[int] = None  # None = 128, or 256 past 500k tris
    mxu_chunk: int = 512  # triangles per matrix product ("mxu" backend)
    # mesh-size tiers of the cluster caster (see raycast.ClusterRayCaster):
    # resident tier up to here, stream above
    mxu_max_tris: int = MXU_MAX_TRIS
    mxu_stream_max_tris: Optional[int] = None  # None = 32767 * cluster_size
    # exactly-zero Plücker side products (a ray through a shared edge)
    # agree with any sign instead of counting as +0/-0 signs
    edge_wildcard: bool = False


@dataclasses.dataclass(frozen=True)
class MarchingCubesConfig:
    # None -> the eager API computes counts first; set capacities for
    # fixed-shape pipelines
    vert_capacity: Optional[int] = None
    face_capacity: Optional[int] = None
    # the JAX package's compaction unit budgets: accepted and unused, as
    # there (its selection is exact and needs none)
    vert_units: int = 0
    cube_units: int = 0
    active_capacity: int = 0  # active-cube budget (0 = face_capacity)


@dataclasses.dataclass(frozen=True)
class Config:
    raycast: RayCastConfig = dataclasses.field(default_factory=RayCastConfig)
    marching_cubes: MarchingCubesConfig = dataclasses.field(
        default_factory=MarchingCubesConfig
    )


DEFAULT = Config()
