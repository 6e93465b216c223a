"""Marching tetrahedra on the sphere tet-mesh fixture, on the port.

The PyTorch counterpart of ``examples/sphere_tetrahedra.py``: the mesh of
``examples/data/tetrahedra`` and ``sphere_tetrahedra.ply``.

    python examples/torch/sphere_tetrahedra.py [--device cuda|cpu]
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import primitive3d_tpu_torch as p3t  # noqa: E402

DATA = os.path.join(ROOT, "examples", "data", "tetrahedra")


def main(device: str) -> None:
    points = np.load(os.path.join(DATA, "points.npy"))
    sdfs = np.load(os.path.join(DATA, "sdfs.npy"))
    tets = np.load(os.path.join(DATA, "tetrahedras.npy"))
    with p3t.Timer("marching tetrahedra: {:.6f}s", device=device):
        verts, faces = p3t.marching_tetrahedras(points, tets, sdfs,
                                                device=device)
    print(f"#vertices={verts.shape[0]} #triangles={faces.shape[0]}")
    p3t.save_mesh(verts, faces, filename="sphere_tetrahedra.ply")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
