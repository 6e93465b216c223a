"""Opt-in debug assertions.

Counterpart of ``primitive3d_tpu/core/debug.py``. ``check(pred, msg)``
calls sit at the invariant sites (capacity overflow, non-finite rays); they
do nothing unless a ``checks()`` scope is active, so the production path
never waits on the device for them. Inside the scope a check reads its
predicate back to the host and raises ``CheckError`` when it is false.

    from primitive3d_tpu_torch.core import debug

    with debug.checks():
        marching_cubes_padded(grid, 0.0, vert_capacity=8, face_capacity=8)
        # raises CheckError: capacity overflow

    debug.checked(marching_cubes_padded)(grid, 0.0, vert_capacity=8,
                                         face_capacity=8)  # the same
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

_state = threading.local()


class CheckError(RuntimeError):
    pass


def enabled() -> bool:
    return getattr(_state, "on", False)


@contextlib.contextmanager
def checks():
    """Enable debug checks for calls made inside this scope."""
    prev = enabled()
    _state.on = True
    try:
        yield
    finally:
        _state.on = prev


def check(pred, msg: str, **fmt) -> None:
    """Raise ``CheckError`` if ``pred`` is false; no-op outside ``checks()``."""
    if not enabled():
        return
    if not bool(pred):
        vals = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in fmt.items()}
        raise CheckError(msg.format(**vals))


def checked(fn):
    """``fn`` wrapped to run inside a :func:`checks` scope: the first failed
    :func:`check` raises ``CheckError``. The JAX package's ``errors=``
    (checkify error sets) has no counterpart here."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with checks():
            return fn(*args, **kwargs)

    return wrapper


def check_finite(x: torch.Tensor, name: str) -> None:
    if enabled():
        check(torch.isfinite(x).all(), f"{name} contains non-finite values")
