"""Camera ray generation in coherent tile order (numpy).

The port's copy of ``primitive3d_tpu/render/camera.py``. The cluster caster
culls work at 256-ray chunk granularity (RCHUNK in
kernels/raycast_kernel.py), and one chunk is one CUDA block of the cast
kernel; a chunk's cost is the union of clusters its rays touch, so chunk
coherence is a first-order performance knob. ``camera_rays`` emits pinhole
rays in TILE x TILE = 16x16 pixel tiles — each 256-ray chunk is a compact
square of the image — plus the permutation to scatter results back to
row-major order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TILE = 16  # 16*16 == RCHUNK of the cast kernels: one chunk = one image quad


class CameraRays(NamedTuple):
    origins: np.ndarray  # (H*W, 3) float32, tile-blocked order
    dirs: np.ndarray  # (H*W, 3) float32, unit length
    # (H*W,) int32: ray/result i belongs to flat pixel inv_order[i]
    inv_order: np.ndarray

    def to_image(self, values: np.ndarray, H: int, W: int) -> np.ndarray:
        """Unscramble per-ray results back into an (H, W, ...) image."""
        out = np.empty((H * W, *values.shape[1:]), values.dtype)
        out[self.inv_order] = np.asarray(values)
        return out.reshape(H, W, *values.shape[1:])


def tile_order(H: int, W: int, tile: int = TILE) -> np.ndarray:
    """Permutation p such that rays[p] is in tile-blocked order."""
    ys, xs = np.mgrid[0:H, 0:W]
    tiles_w = (W + tile - 1) // tile
    key = ((ys // tile) * tiles_w + (xs // tile)) * (tile * tile) + (
        ys % tile
    ) * tile + (xs % tile)
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


def camera_rays(
    H: int,
    W: int,
    origin,
    look_at=None,
    fov_y: float = 45.0,
    up=(0.0, 1.0, 0.0),
) -> CameraRays:
    """Pinhole camera rays in tile-blocked order."""
    origin = np.asarray(origin, np.float32)
    look_at = np.asarray(
        (0.0, 0.0, 0.0) if look_at is None else look_at, np.float32
    )
    fwd = look_at - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    ndc_x = (xs + 0.5) / W - 0.5
    ndc_y = (ys + 0.5) / H - 0.5
    tan_half = np.tan(np.radians(fov_y) / 2)
    d = (
        fwd[None, None]
        + ndc_x[..., None] * right * (2 * tan_half * W / H)
        - ndc_y[..., None] * true_up * (2 * tan_half)
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    p = tile_order(H, W)  # ray i is pixel p[i]; to_image scatters back via p
    o = np.tile(origin, (H * W, 1))
    return CameraRays(o[p].astype(np.float32), d[p].astype(np.float32), p)
