"""The port's binding of the native host runtime against the JAX package's
(CPU): the same C library, built by the port into its own ``_build/``."""
import os
import shutil

import numpy as np
import pytest
import torch

from primitive3d_tpu import native as jnative
from primitive3d_tpu_torch import native
from primitive3d_tpu_torch.bvh.traverse import cast_rays
from primitive3d_tpu_torch.io.ply import save_mesh
from primitive3d_tpu_torch.raycast import create_raycaster
from tests.oracles.raycast_numpy import icosphere

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("the native runtime needs g++")


@pytest.fixture(scope="module")
def sphere():
    v, f = icosphere(2)
    rng = np.random.default_rng(1)
    o = (rng.standard_normal((200, 3)) * 3).astype(np.float32)
    # aimed at points near the centre, so that most rays hit
    d = (rng.standard_normal((200, 3)) * 0.7 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.asarray(v, np.float32), f, o, d


def test_builds_outside_native_dir():
    before = sorted(os.listdir(NATIVE_DIR))
    assert native.available()
    assert sorted(os.listdir(NATIVE_DIR)) == before
    built = [p.name for p in native.BUILD_DIR.glob("prim3d_native-*.so")]
    assert built, "no library in the port's _build/"


def test_lbvh_bit_equal_to_jax(sphere):
    v, f, _, _ = sphere
    tris = v[f]
    want = jnative.build_lbvh(tris)
    got = native.build_lbvh(torch.from_numpy(tris), device="cpu")
    assert type(got).__name__ == "LBVH"
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert isinstance(g, torch.Tensor) and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_raycast_equal_to_jax(sphere):
    v, f, o, d = sphere
    tris = v[f]
    want = jnative.raycast(jnative.build_lbvh(tris), o, d)
    got = native.raycast(native.build_lbvh(tris, device="cpu"),
                         torch.from_numpy(o), d)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert 100 < (got[2] >= 0).sum() < 200


def test_host_tree_walked_by_traverse(sphere):
    """``bvh.traverse.cast_rays`` over the native tree equals a brute force
    over the same triangles."""
    v, f, o, d = sphere
    bvh = native.build_lbvh(v[f], device="cpu")
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    depth, leaf = cast_rays(bvh, ot, dt, 10.0)
    fid = torch.where(leaf >= 0, bvh.prim_order[leaf.clamp(min=0).long()], -1)
    ref = create_raycaster(v, f, backend="bruteforce", device="cpu").cast(
        ot, dt)
    assert torch.equal(fid, ref.face_id)
    assert torch.allclose(depth[fid >= 0], ref.depth[fid >= 0], rtol=1e-6,
                          atol=1e-6)


def test_save_ply_byte_equal(tmp_path):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((10, 3)).astype(np.float32)
    f = rng.integers(0, 10, (7, 3)).astype(np.int32)
    c = rng.integers(0, 255, (10, 3)).astype(np.uint8)
    for colors in (c, None):
        paths = [tmp_path / f"{k}.ply" for k in ("port", "jax", "py")]
        native.save_ply(paths[0], torch.from_numpy(v), f, colors)
        jnative.save_ply(paths[1], v, f, colors)
        save_mesh(v, f, colors, filename=paths[2])
        assert paths[0].read_bytes() == paths[1].read_bytes() \
            == paths[2].read_bytes()


def test_build_error_is_raised(tmp_path, monkeypatch):
    """A failed build makes ``available()`` False and every entry point
    raise with the compiler's own message, not fall back."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="broken.cpp.*error"):
        native.build_lbvh(np.zeros((2, 3, 3), np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.save_ply(tmp_path / "x.ply", np.zeros((1, 3)),
                        np.zeros((0, 3)))
    assert not list((tmp_path / "_build").glob("*.so"))
