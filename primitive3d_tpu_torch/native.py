"""ctypes binding of the native host runtime (``native/prim3d_native.cpp``).

Counterpart of ``primitive3d_tpu/native.py``, over the same C entry points
(``p3d_build_lbvh``, ``p3d_raycast``, ``p3d_save_ply``). The library is
compiled with ``g++`` and the flags of ``native/Makefile`` at first use, into
``primitive3d_tpu_torch/_build/`` (nothing is written into ``native/``),
under a name that carries a hash of the source, the flags and the host's
CPU target: ``-march=native`` makes a library built on one host unsafe on
another. The compiler writes a temporary file that is renamed into place,
so processes that build at once never load a half-written library.

There is no silent fallback: :func:`available` may return False, but
:func:`build_lbvh`, :func:`raycast` and :func:`save_ply` raise with the
compiler's own error text. The native LBVH is the struct-of-arrays layout
of ``bvh.lbvh.LBVH``, so ``bvh.traverse.cast_rays`` walks a tree built on
the host on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .bvh.lbvh import LBVH
from .core.device import DeviceLike, resolve_device

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "native" / "prim3d_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS and link line
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _cxx() -> str:
    path = shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found: the native runtime needs a C++ "
                           "compiler")
    return path


def _cpu_target(cxx: str) -> str:
    """The target ``-march=native`` resolves to on this host, as the
    compiler reports it, beside the machine type."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=False).stdout
    march = next((ln.split()[-1] for ln in out.splitlines()
                  if ln.strip().startswith("-march=")), "unknown")
    return f"{platform.machine()}-{march}"


def _target(cxx: str) -> Path:
    key = b"\0".join([SOURCE.read_bytes(), cxx.encode(),
                      " ".join(CXX_FLAGS + LIBS).encode(),
                      _cpu_target(cxx).encode()])
    return BUILD_DIR / f"prim3d_native-{hashlib.sha1(key).hexdigest()[:12]}.so"


def _build() -> Path:
    cxx = _cxx()
    out = _target(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.p3d_build_lbvh.restype = ctypes.c_int
    lib.p3d_build_lbvh.argtypes = [
        f32p, ctypes.c_int32, i32p, i32p, f32p, f32p, i32p, i32p, i32p, f32p,
    ]
    lib.p3d_raycast.restype = None
    lib.p3d_raycast.argtypes = [
        i32p, i32p, f32p, f32p, i32p, i32p, i32p, f32p, ctypes.c_int32,
        f32p, f32p, ctypes.c_int32, ctypes.c_float, f32p, f32p, i32p,
    ]
    lib.p3d_save_ply.restype = ctypes.c_int
    lib.p3d_save_ply.argtypes = [
        ctypes.c_char_p, f32p, u8p, ctypes.c_int32, i32p, ctypes.c_int32,
    ]
    return lib


def _load() -> ctypes.CDLL:
    """The bound library, built on first use; raises with the build's
    error text, once per process and on every later call."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (RuntimeError, OSError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"native library unavailable: {_error}")
        return _lib


def available() -> bool:
    """Whether the native library builds and loads on this host."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def build_lbvh(tris, device: DeviceLike = "cuda") -> LBVH:
    """Host-parallel LBVH build over triangles (T, 3, 3), T >= 2.

    Returns ``bvh.lbvh.LBVH`` of tensors on ``device``.
    """
    dev = resolve_device(device)
    lib = _load()
    tris = _host(tris, np.float32).reshape(-1, 3, 3)
    T = tris.shape[0]
    if T < 2:
        raise ValueError(f"an LBVH needs at least 2 triangles, got {T}")
    left = np.empty(T - 1, np.int32)
    right = np.empty(T - 1, np.int32)
    box_lo = np.empty((T - 1, 3), np.float32)
    box_hi = np.empty((T - 1, 3), np.float32)
    escape = np.empty(T - 1, np.int32)
    escape_leaf = np.empty(T, np.int32)
    prim_order = np.empty(T, np.int32)
    tris_sorted = np.empty((T, 3, 3), np.float32)
    rc = lib.p3d_build_lbvh(
        tris.reshape(-1, 9), T, left, right,
        box_lo.reshape(-1), box_hi.reshape(-1), escape, escape_leaf,
        prim_order, tris_sorted.reshape(-1, 9),
    )
    if rc != 0:
        raise ValueError(f"p3d_build_lbvh failed: {rc}")
    return LBVH(*(torch.from_numpy(a).to(dev) for a in (
        left, right, box_lo, box_hi, escape, escape_leaf, tris_sorted,
        prim_order)))


def raycast(bvh: LBVH, origins, dirs, max_dist: float = 10.0
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded closest-hit cast on the host over an LBVH (tensors on any
    device, or numpy). Returns numpy (depth (R,), normals (R, 3), face_id
    (R,)), face ids in the original triangle order, -1 on a miss."""
    lib = _load()
    o = _host(origins, np.float32).reshape(-1, 3)
    d = _host(dirs, np.float32).reshape(-1, 3)
    R = o.shape[0]
    tris_sorted = _host(bvh.tris_sorted, np.float32).reshape(-1, 9)
    depth = np.empty(R, np.float32)
    normals = np.empty((R, 3), np.float32)
    face_id = np.empty(R, np.int32)
    lib.p3d_raycast(
        _host(bvh.left, np.int32), _host(bvh.right, np.int32),
        _host(bvh.box_lo, np.float32).reshape(-1),
        _host(bvh.box_hi, np.float32).reshape(-1),
        _host(bvh.escape, np.int32), _host(bvh.escape_leaf, np.int32),
        _host(bvh.prim_order, np.int32), tris_sorted, tris_sorted.shape[0],
        o, d, R, float(max_dist), depth, normals, face_id,
    )
    return depth, normals, face_id


def save_ply(filename, vertices, faces, colors=None) -> None:
    """Native binary PLY writer, the format of ``io.ply.save_mesh``."""
    lib = _load()
    v = _host(vertices, np.float32).reshape(-1, 3)
    f = _host(faces, np.int32).reshape(-1, 3)
    if colors is None:
        c = np.full((v.shape[0], 3), 127, np.uint8)
    else:
        c = _host(colors, np.uint8).reshape(-1, 3)
    rc = lib.p3d_save_ply(str(filename).encode(), v, c, v.shape[0], f,
                          f.shape[0])
    if rc != 0:
        raise IOError(f"p3d_save_ply failed: {rc}")
