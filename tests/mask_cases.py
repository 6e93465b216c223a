"""Grids for the mask pass's tests, without JAX: the card tests
(``tests/test_torch_cuda.py``) run where JAX is not installed."""
import numpy as np


def special_grid(shape, thresh, seed):
    """A normal grid with values exactly at ``thresh``, +-inf and NaN
    sprinkled through it (NaN is outside: ``density > thresh`` is false)."""
    grid = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    flat = grid.reshape(-1)
    flat[::7] = np.float32(thresh)
    flat[3::11] = np.inf
    flat[5::13] = -np.inf
    flat[2::17] = np.nan
    return grid
