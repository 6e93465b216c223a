"""Profiling helpers.

Counterpart of ``primitive3d_tpu/core/profiling.py``: a profiler trace
context, an amortised timer and the throughput line. ``trace`` records
``torch.profiler`` activity (the card's kernels too, where there is one) and
writes a Chrome trace; ``amortized_seconds`` times dependent calls between
two CUDA events on the card (a host clock there would measure only the
enqueue), or with ``perf_counter`` on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import torch

from .device import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the body; write ``<log_dir>/trace.json`` (Chrome / Perfetto)
    on exit. ``log_dir`` defaults to ``prim3d_trace`` in the temp dir."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "prim3d_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def amortized_seconds(fn_scalar: Callable, iters: int = 10,
                      device: DeviceLike = "cuda") -> float:
    """Seconds per call of ``fn_scalar(salt) -> 0-d tensor`` over ``iters``
    dependent calls (each salt depends on the previous result), after one
    warm-up run of the same loop."""
    dev = resolve_device(device)
    z = torch.zeros((), dtype=torch.float32, device=dev)

    def looped():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            acc = acc + fn_scalar(acc * 1e-30 + z)
        return acc

    float(looped())  # warm-up
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        looped()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    float(looped())
    return (time.perf_counter() - t0) / iters


def report_throughput(
    name: str, items: int, seconds: float, unit: str = "items"
) -> str:
    rate = items / seconds
    scale, suffix = (1e6, "M") if rate >= 1e6 else (1e3, "K")
    line = f"{name}: {seconds*1e3:.2f} ms = {rate/scale:.2f} {suffix}{unit}/s"
    print(line)
    return line
