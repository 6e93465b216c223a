"""Marching-cubes mask pass: CUDA kernel ``csrc/mc_masks.cu`` + plain version.

Counterpart of ``primitive3d_tpu/kernels/mc_masks.py``. One pass over the
density grid gives the three edge-crossing masks and the 8-bit corner mask
of every cube, in their valid shapes:

    cx (X-1, Y, Z) int8, cy (X, Y-1, Z) int8, cz (X, Y, Z-1) int8,
    cube_mask (X-1, Y-1, Z-1) uint8

``fused_masks`` launches the kernel for a CUDA tensor and runs
``fused_masks_plain`` for a CPU tensor; there is no fallback between them.
On the card the four outputs are views of one byte buffer (the callers only
read them), and rows may be at most ``MAX_Z`` cells long.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor
# longest z-row the kernel takes: three shared-memory buffers of two rows
# must fit a block (csrc/mc_masks.cu MAX_Z)
MAX_Z = 32768

KERNEL = _build.Kernel(
    "mc_masks", "mc_masks.cu",
    replaces="primitive3d_tpu/kernels/mc_masks.py:29",
    argtypes=[ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p],
)


def fused_masks_plain(density: Tensor, thresh: float
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The mask pass as tensor comparisons (same outputs as the kernel)."""
    occ = density > float(np.float32(thresh))
    cx = (occ[:-1] != occ[1:]).to(torch.int8)
    cy = (occ[:, :-1] != occ[:, 1:]).to(torch.int8)
    cz = (occ[:, :, :-1] != occ[:, :, 1:]).to(torch.int8)
    o = occ.to(torch.uint8)
    cm = (o[:-1, :-1, :-1]
          | (o[1:, :-1, :-1] << 1)
          | (o[1:, 1:, :-1] << 2)
          | (o[:-1, 1:, :-1] << 3)
          | (o[:-1, :-1, 1:] << 4)
          | (o[1:, :-1, 1:] << 5)
          | (o[1:, 1:, 1:] << 6)
          | (o[:-1, 1:, 1:] << 7))
    return cx, cy, cz, cm


def fused_masks(density: Tensor, thresh: float
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(cx, cy, cz, cube_mask) of a (X, Y, Z) float32 grid, each dim >= 2."""
    if density.dtype != torch.float32 or density.dim() != 3:
        raise ValueError(
            f"density must be a 3-D float32 tensor, got {density.dtype} "
            f"{tuple(density.shape)}")
    X, Y, Z = density.shape
    if min(X, Y, Z) < 2:
        raise ValueError(f"every grid dim must be >= 2, got {(X, Y, Z)}")
    if density.device.type == "cpu":
        return fused_masks_plain(density, thresh)
    if density.device.type != "cuda":
        raise ValueError(f"unsupported device {density.device}")
    if not density.is_contiguous():
        raise ValueError("density must be contiguous")
    if Z > MAX_Z:
        raise ValueError(f"the mask kernel takes z-rows of at most {MAX_Z} "
                         f"cells, got {Z}")
    shapes = ((X - 1, Y, Z), (X, Y - 1, Z), (X, Y, Z - 1),
              (X - 1, Y - 1, Z - 1))
    # one allocation, each output starting on a 16-byte boundary
    sizes = [a * b * c for a, b, c in shapes]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + -(-n // 16) * 16)
    buf = torch.empty(offs[-1] + sizes[-1], dtype=torch.uint8,
                      device=density.device)
    cx, cy, cz, cm = (buf[o:o + n].view(sh)
                      for o, n, sh in zip(offs, sizes, shapes))
    cx, cy, cz = cx.view(torch.int8), cy.view(torch.int8), cz.view(torch.int8)
    dev = density.device
    with torch.cuda.device(dev):
        KERNEL.launch(density.data_ptr(), float(np.float32(thresh)), X, Y, Z,
                      cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
                      cm.data_ptr())
    return cx, cy, cz, cm
