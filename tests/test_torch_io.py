"""The port's PLY I/O, ``canonical`` and ``__version__`` against the JAX
package's (CPU): the same meshes, made with numpy from fixed seeds, written
by both writers must give the same bytes."""
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.core import canonical as jcanon
from primitive3d_tpu.io import ply as jply
from primitive3d_tpu_torch.core import canonical as pcanon
from primitive3d_tpu_torch.io import ply as pply


@pytest.fixture
def mesh():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((10, 3)).astype(np.float32)
    f = rng.integers(0, 10, (7, 3)).astype(np.int64)
    c = rng.integers(0, 255, (10, 3)).astype(np.int64)
    return v, f, c


@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("kind", ["numpy", "tensor", "grad_tensor"])
def test_bytes_equal_jax_writer(tmp_path, mesh, colors, kind):
    """Faces int64 and colours int64 are cast as the JAX writer casts them;
    a tensor that requires grad is detached."""
    v, f, c = mesh
    c = c if colors else None
    want, got = tmp_path / "jax.ply", tmp_path / "port.ply"
    jply.save_mesh(v, f, c, filename=want)
    if kind != "numpy":
        v = torch.from_numpy(v).requires_grad_(kind == "grad_tensor")
        f = torch.from_numpy(f)
        c = None if c is None else torch.from_numpy(c)
    p3t.save_mesh(v, f, c, filename=str(got))
    assert got.read_bytes() == want.read_bytes()
    for a, b in zip(jply.load_mesh(want), p3t.load_mesh(got)):
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_round_trip_default_grey(tmp_path, mesh):
    v, f, _ = mesh
    p3t.save_mesh(v, f, filename=tmp_path / "m.ply")
    v2, f2, c2 = p3t.load_mesh(tmp_path / "m.ply")
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    assert f2.dtype == np.int32 and (c2 == 127).all()


def test_errors(tmp_path, mesh):
    v, f, _ = mesh
    with pytest.raises(NotImplementedError):
        pply.save_mesh(v, f, filename=tmp_path / "m.obj")
    with pytest.raises(ValueError, match="do not match"):
        pply.save_mesh(v, f, np.zeros((3, 3)), filename=tmp_path / "m.ply")


def test_canonical_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((30, 3)).astype(np.float32)
    f = rng.integers(0, 30, (40, 3))
    for a, b in zip(jcanon.canonicalize_mesh(v, f),
                    pcanon.canonicalize_mesh(v, f)):
        np.testing.assert_array_equal(a, b)
    perm = rng.permutation(30)
    inv = np.argsort(perm)
    pcanon.assert_meshes_equal(v, f, v[perm], inv[f][rng.permutation(40)])
    with pytest.raises(AssertionError):
        pcanon.assert_meshes_equal(v, f, v[:29], f)


def test_version():
    assert p3t.__version__ == p3d.__version__ == "0.1.0"
