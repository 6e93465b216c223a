"""Binary PLY mesh export and import.

Counterpart of ``primitive3d_tpu/io/ply.py``, byte for byte: binary
little-endian PLY with float x/y/z and uchar r/g/b per vertex and int-list
faces, each prefixed with a count of 3; faces cast to int32, colours default
to 127-grey. Numpy arrays and tensors on any device are accepted: a tensor
is detached and copied to the host, and the file is written from numpy.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_mesh(
    vertices,
    faces,
    colors=None,
    filename: PathLike = "temp.ply",
    verbose: bool = False,
) -> None:
    """Save a triangle mesh as binary little-endian PLY.

    ``colors`` defaults to 127-grey; values are cast to uint8. Only ``.ply``
    output is supported.
    """
    filename = str(filename)
    if not filename.endswith(".ply"):
        raise NotImplementedError("only .ply export is supported")

    v = _to_numpy(vertices).astype("<f4", copy=False).reshape(-1, 3)
    f = _to_numpy(faces).astype("<i4", copy=False).reshape(-1, 3)
    if colors is None:
        c = np.full((v.shape[0], 3), 127, np.uint8)
    else:
        c = _to_numpy(colors).astype(np.uint8, copy=False).reshape(-1, 3)
    if c.shape[0] != v.shape[0]:
        raise ValueError(f"colors {c.shape} do not match vertices {v.shape}")

    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {v.shape[0]}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        f"element face {f.shape[0]}\n"
        "property list int int vertex_index\n"
        "end_header\n"
    )
    vert_rec = np.zeros(
        v.shape[0], dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
    vert_rec["xyz"] = v
    vert_rec["rgb"] = c
    face_rec = np.concatenate(
        [np.full((f.shape[0], 1), 3, "<i4"), f], axis=1).astype("<i4")

    with open(filename, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(vert_rec.tobytes())
        fh.write(face_rec.tobytes())

    if verbose:
        print(f"save as {filename} successfully!")


def load_mesh(
    filename: PathLike,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Load a PLY written by :func:`save_mesh` (binary LE, xyz+rgb, int faces).

    Returns numpy (vertices float32 (N, 3), faces int32 (F, 3), colors uint8
    (N, 3) or None).
    """
    data = Path(filename).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if (header[0] != "ply"
            or "format binary_little_endian 1.0" not in header[1]):
        raise ValueError("not a binary little-endian PLY file")

    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header[2:]:
        parts = line.split()
        if parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex":
            vert_props.append((parts[-1], parts[1]))

    type_map = {"float": "<f4", "uchar": "u1", "int": "<i4", "double": "<f8"}
    rec_dtype = np.dtype([(n, type_map[t]) for n, t in vert_props])
    body = data[end:]
    verts_rec = np.frombuffer(body, dtype=rec_dtype, count=n_vert)
    off = n_vert * rec_dtype.itemsize
    names = [n for n, _ in vert_props]
    vertices = np.stack(
        [verts_rec["x"], verts_rec["y"], verts_rec["z"]], axis=-1
    ).astype(np.float32)
    colors = None
    if {"red", "green", "blue"} <= set(names):
        colors = np.stack(
            [verts_rec["red"], verts_rec["green"], verts_rec["blue"]], axis=-1
        ).astype(np.uint8)

    face_rec = np.frombuffer(body, dtype="<i4", count=n_face * 4, offset=off)
    face_rec = face_rec.reshape(n_face, 4)
    if n_face and not (face_rec[:, 0] == 3).all():
        raise ValueError("only pure-triangle PLY faces are supported")
    return vertices, face_rec[:, 1:].astype(np.int32), colors
