"""LBVH ray caster (the ``"bvh"`` backend): build once, cast many.

Counterpart of ``primitive3d_tpu/bvh/caster.py``: the LBVH build
(``lbvh.py``) and the stackless traversal (``traverse.py``), with the same
depth / normal / face-id buffers and miss semantics as the other casters.
Meshes of fewer than 2 triangles have no tree and are cast by brute force.
"""
from __future__ import annotations

import torch

from ..core.device import DeviceLike
from ..raycast import (DEFAULT_MAX_DIST, RayCaster, RayHits, _cast_bruteforce,
                       _hit_normals)
from .lbvh import build_lbvh
from .traverse import cast_rays


class BvhRayCaster(RayCaster):
    def __init__(self, vertices, faces, max_dist: float = DEFAULT_MAX_DIST,
                 device: DeviceLike = "cuda"):
        super().__init__(vertices, faces, max_dist, device)
        self.bvh = (build_lbvh(self.triangles) if self.num_triangles >= 2
                    else None)

    def cast(self, origins, directions) -> RayHits:
        o, d = self._rays(origins, directions)
        if self.bvh is None:
            return _cast_bruteforce(self.triangles, o, d, self.max_dist, 8)
        depth, leaf = cast_rays(self.bvh, o, d, self.max_dist)
        face_id = torch.where(
            leaf >= 0, self.bvh.prim_order[leaf.clamp(min=0).to(torch.int64)],
            -1)
        return RayHits(depth, _hit_normals(self.bvh.tris_sorted, leaf),
                       face_id)
