"""Marching cubes on the bunny SDF fixture, on the port.

The PyTorch counterpart of ``examples/bunny_sdf.py``: the mesh, its counts
against the golden file of the repo's tests, and ``bunny.ply``.

    python examples/torch/bunny_sdf.py [--device cuda|cpu]
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import primitive3d_tpu_torch as p3t  # noqa: E402

DATA = os.path.join(ROOT, "examples", "data", "bunny.npy")


def main(device: str) -> None:
    grid = np.load(DATA)
    print(f"DENSITY_GRID shape: {grid.shape}")
    with p3t.Timer("marching cubes: {:.6f}s", device=device):
        vertices, faces = p3t.marching_cubes(grid, 0.0, verbose=True,
                                             device=device)
    with p3t.Timer("save mesh: {:.6f}s"):
        p3t.save_mesh(vertices, faces, filename="bunny.ply")
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "bunny_mc.npz"))
    if (vertices.shape[0], faces.shape[0]) != (golden["v"].shape[0],
                                               golden["f"].shape[0]):
        raise SystemExit(f"counts {vertices.shape[0]} / {faces.shape[0]} "
                         f"differ from the golden file's")
    print("golden count parity OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
