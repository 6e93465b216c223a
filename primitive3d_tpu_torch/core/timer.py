"""Wall-clock and device timing utilities.

``Timer`` is the context-manager + checkpoint timer of the JAX package
(``primitive3d_tpu/core/timer.py``). On a CUDA device the work is
asynchronous, so both ``Timer`` and ``time_fn`` time with CUDA events
there and with ``time.perf_counter`` on the CPU.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from .device import DeviceLike


class TimerError(Exception):
    pass


class _Clock:
    """Seconds between marks: CUDA events on the card, perf_counter else."""

    def __init__(self, device: Optional[DeviceLike]):
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        if not self.cuda:
            return b - a
        b.synchronize()
        return a.elapsed_time(b) / 1e3


class Timer:
    """Context-manager + checkpoint timer.

        with Timer("marching cubes: {:.6f}s", device="cuda"):
            ...                      # prints elapsed on exit
        t = Timer()
        t.since_start()              # seconds since construction
        t.since_last_check()         # seconds since previous check
    """

    def __init__(self, print_tmpl: Optional[str] = None, start: bool = True,
                 device: Optional[DeviceLike] = None):
        self._is_running = False
        self._clock = _Clock(device)
        if print_tmpl is not None and "{" not in print_tmpl:
            print_tmpl += " {:.3f}"
        self.print_tmpl = print_tmpl if print_tmpl else "{:.3f}"
        if start:
            self.start()

    @property
    def is_running(self) -> bool:
        return self._is_running

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        print(self.print_tmpl.format(self.since_last_check()))
        self._is_running = False

    def start(self) -> None:
        if not self._is_running:
            self._t_start = self._clock.mark()
            self._is_running = True
        self._t_last = self._clock.mark()

    def since_start(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        self._t_last = self._clock.mark()
        return self._clock.seconds(self._t_start, self._t_last)

    def since_last_check(self) -> float:
        if not self._is_running:
            raise TimerError("timer is not running")
        now = self._clock.mark()
        dur = self._clock.seconds(self._t_last, now)
        self._t_last = now
        return dur


def _cuda_devices(tree: Any, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tuples, lists, dicts
    and NamedTuples, nested)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block(tree: Any) -> Any:
    """Wait until the work of every CUDA device that holds a tensor in
    ``tree`` is done; returns ``tree``. CPU tensors need no wait."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            device: Optional[DeviceLike] = "cuda") -> float:
    """Median seconds per call of ``fn(*args)``.

    Runs ``warmup`` untimed calls first, then ``iters`` timed calls, each
    between two CUDA events on the card (``device=None`` or ``"cpu"``: the
    host clock).
    """
    clock = _Clock(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        a = clock.mark()
        fn(*args)
        times.append(clock.seconds(a, clock.mark()))
    times.sort()
    return times[len(times) // 2]
