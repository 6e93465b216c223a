"""Parity of the port's other ray backends with the JAX package (CPU):
``bruteforce``, ``mxu`` and ``bvh`` (the LBVH build and its stackless
traversal).

Both packages get the same numpy meshes and rays; the JAX casters run on
the CPU as their own tests run them. The LBVH is integer work on the same
Morton codes, so its links, order and boxes are compared exactly. Hits are
compared as the JAX package's own backend tests compare them: face ids
equal (the brute force and the LBVH test each triangle with the same
Möller-Trumbore arithmetic), depth to rtol 2e-6 / atol 1e-6 and normals to
1e-5 (XLA may contract the cross products into FMAs; the port rounds every
product on its own). The all-pairs matrix product sums in another order
than XLA's, so its ids agree on 99% of the rays, as in the JAX package's
test against its brute force.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.bvh.lbvh import DONE as JAX_DONE
from primitive3d_tpu.bvh.lbvh import build_lbvh as jax_build_lbvh
from primitive3d_tpu.raycast import create_raycaster as jax_create
from primitive3d_tpu_torch.bvh.caster import BvhRayCaster
from primitive3d_tpu_torch.bvh.lbvh import DONE, build_lbvh, clz32
from primitive3d_tpu_torch.core.config import RayCastConfig
from primitive3d_tpu_torch.raycast import (BruteForceRayCaster,
                                           ClusterRayCaster, MxuRayCaster)
from tests.oracles.raycast_numpy import cast_numpy, icosphere

BACKENDS = ("bruteforce", "mxu", "bvh")


def random_rays(n, rng, spread=2.0):
    o = rng.standard_normal((n, 3)) * spread
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def rays_at_sphere(n, rng, radius=3.0):
    o = rng.standard_normal((n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * radius
    d = rng.standard_normal((n, 3)) * 0.3 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def meshes():
    """An icosphere under rays from a shell, and a random soup (with
    degenerate faces) under random rays that often miss."""
    rng = np.random.default_rng(7)
    v, f = icosphere(3)
    out = {"icosphere": (np.asarray(v, np.float32), np.asarray(f),
                         *rays_at_sphere(300, rng))}
    v = (rng.standard_normal((200, 3)) * 1.5).astype(np.float32)
    f = rng.integers(0, 200, (500, 3)).astype(np.int32)
    out["soup"] = (v, f, *random_rays(400, rng))
    return out


@pytest.fixture(scope="module")
def cases():
    """Each mesh with each JAX backend's hits, computed once."""
    out = {}
    for name, (v, f, o, d) in meshes().items():
        want = {b: [np.asarray(x) for x in jax_create(v, f, backend=b)
                    .cast(o, d)] for b in BACKENDS}
        out[name] = (v, f, o, d, want)
    return out


def test_clz32_is_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint64),
                        [0, 1, 2, 3, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                        [1 << k for k in range(32)],
                        [(1 << k) - 1 for k in range(1, 33)]])
    want = np.asarray(jax.lax.clz(jnp.asarray(x.astype(np.uint32))))
    got = clz32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64


@pytest.mark.parametrize("n", [2, 17, 100, "icosphere"])
def test_lbvh_matches_jax(n):
    """The same tree: links, escape threads, order and boxes all equal."""
    if n == "icosphere":
        v, f = icosphere(2)
        tris = np.asarray(v, np.float32)[np.asarray(f)]
    else:
        tris = np.random.default_rng(n).standard_normal((n, 3, 3)).astype(
            np.float32)
    want = jax_build_lbvh(jnp.asarray(tris))
    got = build_lbvh(torch.from_numpy(tris))
    for name in got._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert DONE == int(JAX_DONE)
    assert sorted(got.prim_order.tolist()) == list(range(tris.shape[0]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mesh", ["icosphere", "soup"])
def test_backend_matches_jax(cases, mesh, backend):
    v, f, o, d, want = cases[mesh]
    fj, dj, nj = want[backend][2], want[backend][0], want[backend][1]
    rc = p3t.create_raycaster(v, f, backend=backend, device="cpu")
    got = rc.cast(o, d)
    ft, dt, nt = (x.numpy() for x in (got.face_id, got.depth, got.normals))
    assert ft.dtype == np.int32 and dt.shape == (o.shape[0],)
    assert np.mean(ft >= 0) > 0.05
    np.testing.assert_array_equal(ft >= 0, fj >= 0)
    if backend == "mxu":
        same = ft == fj
        assert same.mean() > 0.99
        np.testing.assert_allclose(dt, dj, rtol=2e-4, atol=2e-4)
    else:
        same = np.ones_like(ft, dtype=bool)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(dt, dj, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(nt[same], nj[same], rtol=0, atol=1e-5)
    assert np.all(dt[ft < 0] == 10.0) and not nt[ft < 0].any()


def test_bruteforce_matches_numpy_oracle(cases):
    v, f, o, d, _ = cases["soup"]
    o, d = o[:80], d[:80]
    t_ref, n_ref, id_ref = cast_numpy(v, f, o, d)
    got = BruteForceRayCaster(v, f, device="cpu").cast(o, d)
    np.testing.assert_array_equal(got.face_id.numpy(), id_ref)
    np.testing.assert_allclose(got.depth.numpy(), t_ref, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.normals.numpy(), n_ref, atol=2e-5)


def test_backends_agree_with_cluster_caster(cases):
    """Every backend of the port against its cluster caster at both the
    resident and the scalar-broadcast tier."""
    v, f, o, d, _ = cases["icosphere"]
    ref = BruteForceRayCaster(v, f, device="cpu").cast(o, d)
    for rc in (ClusterRayCaster(v, f, device="cpu"),
               ClusterRayCaster(v, f, mxu_stream_max_tris=0, device="cpu"),
               MxuRayCaster(v, f, device="cpu"),
               BvhRayCaster(v, f, device="cpu")):
        got = rc.cast(o, d)
        same = got.face_id == ref.face_id
        assert float(same.float().mean()) >= 0.99, type(rc).__name__
        torch.testing.assert_close(got.depth, ref.depth, rtol=1e-4,
                                   atol=1e-4)


def test_small_meshes_and_miss_rules():
    """One triangle: the LBVH caster has no tree and casts by brute force
    with chunks of 8; max_dist cuts hits off in every backend."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]])
    o = np.array([[0.2, 0.2, 2.0], [0.2, 0.2, 0.5], [5, 5, 5]], np.float32)
    d = np.tile(np.array([0, 0, -1], np.float32), (3, 1))
    rc = BvhRayCaster(v, f, max_dist=1.0, device="cpu")
    assert rc.bvh is None
    for backend in BACKENDS:
        h = p3t.create_raycaster(v, f, backend=backend, max_dist=1.0,
                                 device="cpu").cast(o, d)
        np.testing.assert_array_equal(h.face_id.numpy(), [-1, 0, -1])
        np.testing.assert_allclose(h.depth.numpy(), [1.0, 0.5, 1.0])
        assert h.normals[1, 2].abs() == 1.0
    assert torch.equal(rc.cast(o, d).face_id, h.face_id)


def test_factory_builds_every_backend():
    v, f = icosphere(1)
    kinds = {"pallas": ClusterRayCaster, "auto": ClusterRayCaster,
             "mxu": MxuRayCaster, "bruteforce": BruteForceRayCaster,
             "bvh": BvhRayCaster}
    for backend, cls in kinds.items():
        rc = p3t.create_raycaster(v, f, backend=backend, device="cpu")
        assert type(rc) is cls
    rc = p3t.create_raycaster(v, f, device="cpu", config=RayCastConfig(
        backend="mxu", mxu_chunk=64, max_dist=3.0))
    assert isinstance(rc, MxuRayCaster) and rc.chunk == 64
    assert rc.max_dist == 3.0
    assert set(p3t.available_backends()) == set(kinds) - {"auto"}
    assert p3t.available_backends() == p3d.available_backends()
