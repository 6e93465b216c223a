"""Grid/bounding-box helpers shared by the surface-extraction ops.

``scale_to_bound`` turns a user-facing ``scale`` argument into an
axis-aligned bounding box ``(lower, upper)``:

  * ``None``                  -> lower = 0, upper = grid resolution (index space)
  * float ``s``               -> cube  [0, s]^3
  * len-3 sequence            -> box   [0, upper]
  * len-2 floats ``(lo, hi)`` -> cube  [lo, hi]^3
  * len-2 of len-3            -> box   [lower, upper]

One convention holds everywhere:
``world = index * (upper - lower) / resolution + lower``.
Counterpart of ``primitive3d_tpu/core/grid.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

ScaleLike = Union[float, Sequence]


def scale_to_bound(scale: ScaleLike) -> Tuple[List[float], List[float]]:
    if isinstance(scale, (float, int)):
        return [0.0, 0.0, 0.0], [float(scale)] * 3
    if isinstance(scale, (list, tuple, np.ndarray)) or hasattr(scale, "shape"):
        seq = list(scale)
        if len(seq) == 3:
            return [0.0, 0.0, 0.0], [float(v) for v in seq]
        if len(seq) == 2:
            a, b = seq
            if isinstance(a, (float, int)):
                return [float(a)] * 3, [float(b)] * 3
            a, b = list(a), list(b)
            if len(a) != 3 or len(b) != 3:
                raise TypeError("len-2 scale must hold two length-3 corners")
            return [float(v) for v in a], [float(v) for v in b]
        raise TypeError(f"scale sequence must have length 2 or 3, got {len(seq)}")
    raise TypeError(f"unsupported scale type: {type(scale)}")


def resolve_bounds(
    shape: Tuple[int, int, int], scale: Optional[ScaleLike]
) -> Tuple[np.ndarray, np.ndarray]:
    """Bounding box for a density grid of the given shape (float32 arrays)."""
    if scale is None:
        lower, upper = [0.0, 0.0, 0.0], [float(s) for s in shape]
    else:
        lower, upper = scale_to_bound(scale)
    return np.asarray(lower, np.float32), np.asarray(upper, np.float32)
