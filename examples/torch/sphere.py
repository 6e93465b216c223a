"""Marching cubes on an analytic sphere grid, on the port.

The PyTorch counterpart of ``examples/sphere.py``: a 200^3 sphere density
grid, ``sphere.ply``, and on an 8x subsampled grid the mesh of ``--device``
against the plain version on the CPU, equal up to vertex and face order
(``core.canonical``).

    python examples/torch/sphere.py [--device cuda|cpu]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import primitive3d_tpu_torch as p3t  # noqa: E402
from primitive3d_tpu_torch.core.canonical import (  # noqa: E402
    assert_meshes_equal)

N = 200
X, Y, Z = np.mgrid[:N, :N, :N]
# inside is density > thresh: the negated squared distance
DENSITY_GRID = -((X - 50) ** 2 + (Y - 50) ** 2 + (Z - 50) ** 2
                 - 25 ** 2).astype(np.float32)


def main(device: str) -> None:
    with p3t.Timer("marching cubes: {:.6f}s", device=device):
        vertices, faces = p3t.marching_cubes(DENSITY_GRID, 0.0, verbose=True,
                                             device=device)
    with p3t.Timer("save mesh: {:.6f}s"):
        p3t.save_mesh(vertices, faces, filename="sphere.ply")

    small = DENSITY_GRID[::8, ::8, ::8].copy()
    v_d, f_d = p3t.marching_cubes(small, 0.0, device=device)
    v_c, f_c = p3t.marching_cubes(small, 0.0, device="cpu")
    assert_meshes_equal(v_d.cpu().numpy(), f_d.cpu().numpy(), v_c.numpy(),
                        f_c.numpy())
    print(f"{device} equals the CPU on the 25^3 grid: OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
