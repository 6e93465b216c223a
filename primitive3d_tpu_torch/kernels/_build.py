"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes``. Nothing
is compiled at import: the first launch of a kernel on the card builds its
source, and ``build()`` builds every source at once, one ``nvcc`` process
each, all started together. Libraries go to ``primitive3d_tpu_torch/_build/``
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.

Every kernel is a :class:`Kernel`: its C entry point, the source it lives in,
the TPU kernel it replaces, and a plain integer count of its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class Kernel:
    """One hand-written kernel: C entry point, source file, launch count."""

    def __init__(self, name: str, source: str, replaces: str,
                 argtypes: Sequence):
        self.name = name
        self.source = source  # file name under csrc/
        self.replaces = replaces  # file:line of the TPU kernel it ports
        # every entry point takes the CUDA stream last and returns
        # cudaGetLastError() after its launch
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None  # the ctypes entry point, resolved at first launch
        KERNELS.append(self)

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if CUDA refused the launch."""
        fn = self._fn
        if fn is None:  # build, load and bind once per process
            fn = getattr(load(self.source), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


KERNELS: List[Kernel] = []


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return path


def _target(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:12]}.so"


def sources() -> List[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the given sources (default: all) that are not built yet.

    One nvcc process per source, all started together. Returns each
    compiled source's compiler output (``-Xptxas=-v`` register and spill
    report); raises with that output if a compile fails.
    """
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / name)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees
            # a half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_target(source)))
            _libs[source] = lib
        return lib
