"""30-bit 3-D Morton codes (bit-interleaved quantised coordinates).

Counterpart of ``primitive3d_tpu/bvh/morton.py``: the same f32 quantisation
in the same order. PyTorch has little uint32 arithmetic, so the bit spread
runs in int64; every step masks to 32 bits, which is what uint32 wraparound
keeps.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def expand_bits(v: Tensor) -> Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Morton codes (int64 holding 30 bits) of points (..., 3) in [lo, hi]."""
    extent = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((points - lo) / extent, 0.0, 1.0) * 1023.0
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int64)  # truncation, as astype
    x = expand_bits(q[..., 0])
    y = expand_bits(q[..., 1])
    z = expand_bits(q[..., 2])
    return (x << 2) | (y << 1) | z
