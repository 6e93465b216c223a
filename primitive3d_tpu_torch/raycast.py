"""Ray casting against triangle meshes: depth / normal / primitive-id buffers.

Counterpart of ``primitive3d_tpu/raycast.py``, with all four backends of
the JAX package:

  * ``pallas``: :class:`ClusterRayCaster` (the JAX package's
    ``PallasRayCaster``) on the card's hand-written cluster kernels, with
    the JAX package's size tiers: resident, stream, and past 32767 clusters
    the scalar-broadcast tier;
  * ``mxu``: :class:`MxuRayCaster`, every ray against every triangle as a
    matrix product (``mxu_cast.py``);
  * ``bruteforce``: :class:`BruteForceRayCaster`, Möller-Trumbore over
    chunks of 512 triangles; exact, the oracle;
  * ``bvh``: ``bvh.caster.BvhRayCaster``, an LBVH and its stackless
    traversal.

Miss semantics are the JAX package's: depth = max_dist (default 10.0),
normal = 0, face_id = -1; hits at t >= max_dist are misses.

Watertightness caveat: by default the cluster kernels' sign-bit test treats
an exactly-zero Plücker side product (a ray exactly through a shared edge)
as +0 / -0 rather than as a wildcard, so such a ray can miss both adjacent
triangles. ``edge_wildcard=True`` (RayCastConfig) makes exact zeros agree
with any sign.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bvh.clusters import (CLUSTER_SIZE, build_cluster_tree, build_clusters,
                           build_mxu_clusters)
from .core import debug
from .core.config import RayCastConfig
from .core.device import DeviceLike, as_tensor, resolve_device
from .geometry import triangle as tri_ops
from .geometry.triangle import dot3
from .kernels.raycast_kernel import (STREAM_MAX_CLUSTERS, cast_clusters,
                                     cast_clusters_mxu)
from .mxu_cast import cast_mxu, triangle_matrix

Tensor = torch.Tensor

DEFAULT_MAX_DIST = 10.0


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


def _cast_bruteforce(tris: Tensor, origins: Tensor, dirs: Tensor,
                     max_dist: float, chunk: int = 512) -> RayHits:
    """Every ray against every triangle, ``chunk`` triangles at a time.

    Padding triangles are all zero, hence never hit. Within a chunk the
    first smallest t wins (``torch.argmin``, as ``jnp.argmin``); across
    chunks a strict ``<``, so earlier chunks win ties.
    """
    T = tris.shape[0]
    R = origins.shape[0]
    dev = tris.device
    pad = (-T) % chunk
    tris_p = torch.cat([tris, tris.new_zeros((pad, 3, 3))]).reshape(
        -1, chunk, 3, 3)
    best_t = torch.full((R,), float(max_dist), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for k in range(tris_p.shape[0]):
        t = tri_ops.ray_intersect(origins[:, None, :], dirs[:, None, :],
                                  tris_p[k][None])  # (R, chunk)
        i = torch.argmin(t, dim=-1)
        tmin = torch.gather(t, 1, i[:, None])[:, 0]
        upd = tmin < best_t
        best_t = torch.where(upd, tmin, best_t)
        best_i = torch.where(upd, (k * chunk + i).to(torch.int32), best_i)
    return RayHits(best_t, _hit_normals(tris, best_i), best_i)


def _hit_normals(tris: Tensor, idx: Tensor) -> Tensor:
    """Unit normals of ``tris[idx]`` (R, 3); zero where idx < 0 (a miss)."""
    n = tri_ops.normals(tris[idx.clamp(min=0).to(torch.int64)])
    return torch.where((idx >= 0)[:, None], n, torch.zeros_like(n))


def _finish_data(triangles: Tensor) -> Tensor:
    """Per-face finish rows (T, 5): [n, a.n, 1/|n|], built once per caster
    so the per-ray finish gathers 5 floats and computes no cross product."""
    a = triangles[:, 0]
    n = torch.linalg.cross(triangles[:, 1] - a, triangles[:, 2] - a, dim=-1)
    inv = 1.0 / torch.clamp(torch.sqrt(dot3(n, n)), min=1e-30)
    return torch.cat([n, dot3(a, n)[:, None], inv[:, None]], dim=-1)


def _finish_hits(fin: Tensor, prim_order: Tensor, depth_k: Tensor,
                 sidx: Tensor, o: Tensor, d: Tensor,
                 max_dist: float) -> RayHits:
    """The scalar-broadcast kernels' (depth, sorted index) as RayHits.

    Maps the index through ``prim_order`` (a padding slot, -1, is a miss)
    and recomputes each winner's depth from its plane, t = (a.n - o.n) /
    d.n, keeping the kernel's depth where the recompute is not a valid hit.
    """
    fid = prim_order[sidx.clamp(min=0).to(torch.int64)]
    hit = (sidx >= 0) & (fid >= 0)
    face_id = torch.where(hit, fid, -1)
    return _refined_hits(fin[face_id.clamp(min=0).to(torch.int64)], hit,
                         face_id, depth_k, o, d, max_dist)


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
    return _refined_hits(finr, hit, face_id, depth_k, o, d, max_dist)


def _refined_hits(rows: Tensor, hit: Tensor, face_id: Tensor,
                  depth_k: Tensor, o: Tensor, d: Tensor,
                  max_dist: float) -> RayHits:
    """RayHits from each ray's winner row ``rows`` (R, >= 5) = [n, a.n,
    1/|n|, ...]: the depth is recomputed from the winner's plane, t = (a.n -
    o.n) / d.n, and the kernel's depth ``depth_k`` stays where that is not
    a valid hit; misses get max_dist and zero normals."""
    nvec = rows[:, :3]
    den = dot3(d, nvec)
    t_exact = (rows[:, 3] - dot3(o, nvec)) / torch.where(
        den == 0, torch.full_like(den, 1e-30), den)
    ok = hit & (den != 0) & (t_exact >= 0.0) & (t_exact < max_dist)
    depth = torch.where(ok, t_exact, depth_k)
    depth = torch.where(hit, depth, torch.full_like(depth, max_dist))
    normals = torch.where(hit[:, None], nvec * rows[:, 4:5],
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


class MxuRayCaster(RayCaster):
    """Every ray against every triangle, one fp32 matrix product per chunk
    of triangles (``mxu_cast.py``); exact, for small meshes."""

    def __init__(self, vertices, faces, max_dist=DEFAULT_MAX_DIST,
                 chunk=512, device: DeviceLike = "cuda"):
        super().__init__(vertices, faces, max_dist, device)
        self.chunk = int(chunk)
        self.w = triangle_matrix(self.triangles)

    def cast(self, origins, directions) -> RayHits:
        o, d = self._rays(origins, directions)
        depth, idx = cast_mxu(self.w, o, d, self.max_dist, self.chunk)
        return RayHits(depth, _hit_normals(self.triangles, idx), idx)


class ClusterRayCaster(RayCaster):
    """Cluster caster on the card's hand-written kernels.

    The JAX package's tier rules, unchanged: meshes of at most
    ``mxu_max_tris`` (default ``MXU_MAX_TRIS``) triangles use the resident
    tier, larger ones the stream tier, and meshes of more than
    ``mxu_stream_max_tris`` (default 32767 clusters) the scalar tier
    (``cast_clusters`` on Morton-order clusters, each ray walking a box tree
    over them built once here, then the finish from per-face rows). The
    cluster size is 128 up to 500k triangles and 256 above.
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
        scap = (STREAM_MAX_CLUSTERS * cs if mxu_stream_max_tris is None
                else mxu_stream_max_tris)
        self.use_mxu = self.num_triangles <= scap
        self.stream = self.num_triangles > cap
        if self.use_mxu:
            self.cbvh = build_mxu_clusters(self.triangles, cluster_size=cs)
        else:
            self.cbvh = build_clusters(self.triangles, cluster_size=cs)
            self.tree = build_cluster_tree(self.cbvh.boxes)
            self._fin = _finish_data(self.triangles)

    def cast(self, origins, directions) -> RayHits:
        o, d = self._rays(origins, directions)
        if self.use_mxu:
            depth, sidx, finr = cast_clusters_mxu(
                self.cbvh, o, d, max_dist=self.max_dist, stream=self.stream,
                with_fin=True, edge_wildcard=self.edge_wildcard)
            return _finish_hits_fin(finr, depth, sidx, o, d, self.max_dist)
        depth, sidx = cast_clusters(self.cbvh, o, d, max_dist=self.max_dist,
                                    tree=self.tree)
        return _finish_hits(self._fin, self.cbvh.prim_order, depth, sidx, o,
                            d, self.max_dist)


class BruteForceRayCaster(RayCaster):
    """Every ray against every triangle in chunks; the exact oracle."""

    def __init__(self, vertices, faces, max_dist=DEFAULT_MAX_DIST, chunk=512,
                 device: DeviceLike = "cuda"):
        super().__init__(vertices, faces, max_dist, device)
        self.chunk = int(chunk)

    def cast(self, origins, directions) -> RayHits:
        o, d = self._rays(origins, directions)
        return _cast_bruteforce(self.triangles, o, d, self.max_dist,
                                self.chunk)


def available_backends() -> tuple:
    """The backends of :func:`create_raycaster`, as in the JAX package."""
    return ("pallas", "mxu", "bvh", "bruteforce")


def create_raycaster(
    vertices,
    faces,
    backend: Optional[str] = None,
    max_dist: Optional[float] = None,
    config: Optional[RayCastConfig] = None,
    device: DeviceLike = "cuda",
) -> RayCaster:
    """Build a ray caster.

    ``backend``: "pallas" (the name the JAX package gives its cluster
    kernels) builds a :class:`ClusterRayCaster`, "mxu" an
    :class:`MxuRayCaster`, "bruteforce" a :class:`BruteForceRayCaster`,
    "bvh" a ``BvhRayCaster``. "auto" builds the cluster caster, the fast
    path on the card (the JAX package's "auto" takes it on a TPU and "mxu"
    elsewhere). ``config`` supplies defaults; explicit arguments override
    it.
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
    if backend == "mxu":
        return MxuRayCaster(vertices, faces, max_dist, chunk=cfg.mxu_chunk,
                            device=device)
    if backend == "bruteforce":
        return BruteForceRayCaster(vertices, faces, max_dist, device=device)
    if backend == "bvh":
        from .bvh.caster import BvhRayCaster

        return BvhRayCaster(vertices, faces, max_dist, device=device)
    raise ValueError(f"unknown backend: {backend!r}")
