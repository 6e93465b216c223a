"""Ray casting against triangle meshes: depth / normal / primitive-id buffers.

Counterpart of ``primitive3d_tpu/raycast.py`` for the cluster backend (the
JAX package's ``PallasRayCaster``, here ``ClusterRayCaster``). Miss
semantics are the JAX package's: depth = max_dist (default 10.0),
normal = 0, face_id = -1; hits at t >= max_dist are misses.

Watertightness caveat: by default the kernels' sign-bit test treats an
exactly-zero Plücker side product (a ray exactly through a shared edge) as
+0 / -0 rather than as a wildcard, so such a ray can miss both adjacent
triangles. ``edge_wildcard=True`` (RayCastConfig) makes exact zeros agree
with any sign.

Backends of the JAX package that are not ported yet (``mxu``, ``bvh``,
``bruteforce`` and the scalar-broadcast tier above 32767 clusters) raise
``NotImplementedError``; nothing falls back to something else.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bvh.clusters import CLUSTER_SIZE, build_mxu_clusters
from .core import debug
from .core.config import RayCastConfig
from .core.device import DeviceLike, as_tensor, resolve_device
from .geometry.triangle import dot3
from .kernels.raycast_kernel import cast_clusters_mxu, check_stream_cap

Tensor = torch.Tensor

DEFAULT_MAX_DIST = 10.0

_NOT_PORTED = {
    "mxu": "ROADMAP.md Queue 1 item 6 (all-pairs mxu_cast)",
    "bvh": "ROADMAP.md Queue 1 item 6 (LBVH caster)",
    "bruteforce": "ROADMAP.md Queue 1 item 6 (BruteForceRayCaster)",
}


class RayHits(NamedTuple):
    depth: Tensor  # (R,) float32; max_dist on miss
    normals: Tensor  # (R, 3) float32; zeros on miss
    face_id: Tensor  # (R,) int32; -1 on miss


def _deindex(vertices, faces, device: torch.device) -> Tensor:
    """Gather faces into a flat (T, 3, 3) triangle array."""
    v = as_tensor(vertices, torch.float32, device)
    f = as_tensor(faces, torch.int64, device)
    if v.dim() != 2 or v.shape[-1] != 3:
        raise ValueError(f"vertices must be (N, 3), got {tuple(v.shape)}")
    if f.dim() != 2 or f.shape[-1] != 3:
        raise ValueError(f"faces must be (F, 3), got {tuple(f.shape)}")
    return v[f]


def _finish_hits_fin(finr: Tensor, depth_k: Tensor, sidx: Tensor, o: Tensor,
                     d: Tensor, max_dist: float) -> RayHits:
    """Elementwise finish from the kernel-selected fin rows (R, 8).

    ``finr`` rows are [n, a.n, 1/|n|, fid, 0, 0] of each ray's winner. The
    depth is recomputed from the winner's plane, t = (a.n - o.n) / d.n, to
    shed the kernel's 2^-17 quantisation; a padding slot (fid < 0) is a
    miss.
    """
    fid_f = finr[:, 5]
    hit = (sidx >= 0) & (fid_f >= 0.0)
    face_id = torch.where(hit, fid_f.to(torch.int32), -1)
    nvec = finr[:, :3]
    den = dot3(d, nvec)
    t_exact = (finr[:, 3] - dot3(o, nvec)) / torch.where(
        den == 0, torch.full_like(den, 1e-30), den)
    ok = hit & (den != 0) & (t_exact >= 0.0) & (t_exact < max_dist)
    depth = torch.where(ok, t_exact, depth_k)
    depth = torch.where(hit, depth, torch.full_like(depth, max_dist))
    normals = torch.where(hit[:, None], nvec * finr[:, 4:5],
                          torch.zeros_like(nvec))
    return RayHits(depth, normals, face_id)


class RayCaster:
    """Ray caster over a fixed triangle mesh (build once, cast many)."""

    def __init__(self, vertices, faces, max_dist: float = DEFAULT_MAX_DIST,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.triangles = _deindex(vertices, faces, self.device)
        self.max_dist = float(max_dist)

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    def cast(self, origins, directions) -> RayHits:
        """Cast rays; returns (depth, normals, face_id), all shape (R, ...)."""
        raise NotImplementedError

    def invoke(self, origins, directions) -> RayHits:
        return self.cast(origins, directions)

    def _rays(self, origins, directions):
        o = as_tensor(origins, torch.float32, self.device).reshape(-1, 3)
        d = as_tensor(directions, torch.float32, self.device).reshape(-1, 3)
        debug.check_finite(o, "ray origins")
        debug.check_finite(d, "ray directions")
        if debug.enabled():
            debug.check((dot3(d, d) > 0.0).all(),
                        "ray directions contain zero-length vectors")
        return o, d


class ClusterRayCaster(RayCaster):
    """Cluster caster on the card's hand-written kernels.

    The JAX package's tier rules, unchanged: meshes of at most
    ``mxu_max_tris`` (default ``MXU_MAX_TRIS``) triangles use the resident
    tier, larger ones the stream tier; the cluster size is 128 up to 500k
    triangles and 256 above. Past 32767 clusters the JAX package switches to its
    scalar-broadcast kernel, which is not ported yet.
    """

    # the one default of the resident-tier cap: RayCastConfig and
    # cast_clusters_diff read it when given no cap
    MXU_MAX_TRIS = 32_000
    AUTO_FAT_CLUSTER_TRIS = 500_000

    def __init__(self, vertices, faces, max_dist=DEFAULT_MAX_DIST,
                 mxu_max_tris=None, mxu_stream_max_tris=None,
                 cluster_size=None, edge_wildcard=False,
                 device: DeviceLike = "cuda"):
        super().__init__(vertices, faces, max_dist, device)
        self.edge_wildcard = bool(edge_wildcard)
        cap = self.MXU_MAX_TRIS if mxu_max_tris is None else mxu_max_tris
        if cluster_size is None:
            cs = (CLUSTER_SIZE if self.num_triangles
                  <= self.AUTO_FAT_CLUSTER_TRIS else 2 * CLUSTER_SIZE)
        else:
            cs = cluster_size
        check_stream_cap(self.num_triangles,
                         32767 * cs if mxu_stream_max_tris is None
                         else mxu_stream_max_tris)
        self.stream = self.num_triangles > cap
        self.cbvh = build_mxu_clusters(self.triangles, cluster_size=cs)

    def cast(self, origins, directions) -> RayHits:
        o, d = self._rays(origins, directions)
        depth, sidx, finr = cast_clusters_mxu(
            self.cbvh, o, d, max_dist=self.max_dist, stream=self.stream,
            with_fin=True, edge_wildcard=self.edge_wildcard)
        return _finish_hits_fin(finr, depth, sidx, o, d, self.max_dist)


def available_backends() -> tuple:
    """Backends that run in this package (the others are not ported yet)."""
    return ("pallas",)


def create_raycaster(
    vertices,
    faces,
    backend: Optional[str] = None,
    max_dist: Optional[float] = None,
    config: Optional[RayCastConfig] = None,
    device: DeviceLike = "cuda",
) -> RayCaster:
    """Build a ray caster.

    ``backend``: "auto" or "pallas" (the name the JAX package gives its
    cluster kernel) build a :class:`ClusterRayCaster`. ``config`` supplies
    defaults; explicit arguments override it.
    """
    cfg = config or RayCastConfig()
    backend = backend or cfg.backend
    max_dist = cfg.max_dist if max_dist is None else max_dist
    if backend in ("auto", "pallas"):
        return ClusterRayCaster(
            vertices, faces, max_dist,
            mxu_max_tris=cfg.mxu_max_tris,
            mxu_stream_max_tris=cfg.mxu_stream_max_tris,
            cluster_size=cfg.cluster_size,
            edge_wildcard=cfg.edge_wildcard,
            device=device,
        )
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: {_NOT_PORTED[backend]}")
    raise ValueError(f"unknown backend: {backend!r}")
