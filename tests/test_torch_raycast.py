"""Parity of the PyTorch port's cluster ray caster with the JAX package (CPU).

The JAX caster runs as its own tests run it off the TPU
(``create_raycaster(..., backend="pallas")`` interprets the Pallas kernels);
the port runs the plain versions of its kernels on CPU tensors. Both get
the same numpy meshes and rays. The port's cluster products are fp32 where
the TPU's are double-bf16 (~f32), so a ray within rounding distance of an
edge may pick the neighbouring triangle: hits are compared by agreement
fraction (hit/miss >= 99.9%, face id >= 99.5%), and where the ids agree,
depth to rtol 1e-5 / atol 1e-6 and normals to atol 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.bvh.clusters import build_mxu_clusters as jax_build
from primitive3d_tpu.core.config import RayCastConfig as JaxConfig
from primitive3d_tpu.kernels import raycast_kernel as jax_rk
from primitive3d_tpu.render.camera import camera_rays as jax_camera_rays
from primitive3d_tpu_torch.bvh.clusters import (build_clusters,
                                                build_mxu_clusters,
                                                from_jax_clusters)
from primitive3d_tpu_torch.core.config import RayCastConfig
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.raycast import ClusterRayCaster
from primitive3d_tpu_torch.render.camera import camera_rays

BUNNY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data", "bunny.npy")


def sphere(n=32, c=(0.13, -0.07, 0.05), r=0.6):
    """Off-centre sphere SDF on [-1, 1]^3: a centred one has exact mirror
    depth ties that two correct casters may break differently."""
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(r) - np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                                    + (z - c[2]) ** 2)).astype(np.float32)


def bunny_mesh():
    v, f = p3d.marching_cubes(np.load(BUNNY), 0.0, scale=1.0)
    return np.asarray(v), np.asarray(f)


def bunny_rays():
    cam = camera_rays(64, 64, origin=(0.43, 0.57, -1.5),
                      look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    return cam.origins, cam.dirs


def soup(T=300, seed=0):
    """Random triangles plus degenerate ones (a point, a repeated vertex)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 1, 3))
    tris = (a + rng.normal(0, 0.1, (T, 3, 3))).astype(np.float32)
    tris[7] = tris[7, :1]  # point triangle
    tris[11, 2] = tris[11, 1]  # repeated vertex
    return tris


def assert_hits_agree(want, got):
    fj, dj, nj = (np.asarray(x) for x in (want.face_id, want.depth,
                                           want.normals))
    ft, dt, nt = (x.numpy() for x in (got.face_id, got.depth, got.normals))
    assert np.mean((fj >= 0) == (ft >= 0)) >= 0.999
    same = fj == ft
    assert np.mean(same) >= 0.995
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nt[same], nj[same], rtol=0, atol=1e-5)
    assert 0.05 < np.mean(ft >= 0) < 0.95


def _w_as_jax(w):
    """The port's (C, S, 24) rows in the JAX (C, 16, 4S) column layout."""
    C, S, _ = w.shape
    out = np.zeros((C, 16, 4, S), np.float32)
    rows = w.transpose(0, 2, 1)
    for e in range(3):
        out[:, 0:6, e] = rows[:, 6 * e:6 * e + 6]
    out[:, 6:10, 3] = rows[:, 18:22]
    return out.reshape(C, 16, 4 * S)


@pytest.mark.parametrize("order", ["morton", "identity"])
def test_clusters_match_jax(order):
    tris = soup()
    jb = jax_build(jnp.asarray(tris), order=order)
    tb = build_mxu_clusters(torch.from_numpy(tris), order=order)
    np.testing.assert_array_equal(np.asarray(jb.boxes), tb.boxes.numpy())
    np.testing.assert_array_equal(np.asarray(jb.prim_order),
                                  tb.prim_order.numpy())
    f = np.asarray(jb.fin).astype(np.float32)
    fin = (f[:, 0:8] + f[:, 8:16] + f[:, 16:24]).transpose(0, 2, 1)
    np.testing.assert_array_equal(fin[..., 5], tb.fin.numpy()[..., 5])
    np.testing.assert_allclose(tb.fin.numpy(), fin, rtol=1e-6, atol=0)
    w2 = np.asarray(jb.w2).astype(np.float32)
    np.testing.assert_allclose(_w_as_jax(tb.w.numpy()),
                               w2[:, 0:16] + w2[:, 32:48], rtol=1e-4,
                               atol=1e-7)
    # degenerate triangles have all-zero rows
    slots = {int(s) for s in np.nonzero(np.isin(tb.prim_order.numpy(),
                                                [7, 11]))[0]}
    for s in slots:
        assert not tb.w.reshape(-1, 24)[s].any()
    base = build_clusters(torch.from_numpy(tris), order=order)
    assert torch.equal(base.boxes, tb.boxes)


def test_from_jax_clusters_round_trip():
    tris = soup(T=256 + 57)
    jb = jax_build(jnp.asarray(tris))
    pb = from_jax_clusters(np.asarray(jb.boxes), np.asarray(jb.w2),
                           np.asarray(jb.prim_order), np.asarray(jb.fin),
                           device="cpu")
    w2 = np.asarray(jb.w2).astype(np.float32)
    np.testing.assert_array_equal(_w_as_jax(pb.w.numpy()),
                                  w2[:, 0:16] + w2[:, 32:48])
    f = np.asarray(jb.fin).astype(np.float32)
    np.testing.assert_array_equal(
        pb.fin.numpy(), (f[:, 0:8] + f[:, 8:16] + f[:, 16:24]
                         ).transpose(0, 2, 1))
    np.testing.assert_array_equal(pb.boxes.numpy(), np.asarray(jb.boxes))
    np.testing.assert_array_equal(pb.prim_order.numpy(),
                                  np.asarray(jb.prim_order))
    assert pb.cluster_size == 128 and pb.num_clusters == 3
    assert all(t.is_contiguous() for t in pb)


@pytest.mark.parametrize("stream", [False, True])
def test_work_lists_match_jax(stream):
    v, f = bunny_mesh()
    jb = jax_build(jnp.asarray(v[f]))
    pb = from_jax_clusters(np.asarray(jb.boxes), np.asarray(jb.w2),
                           np.asarray(jb.prim_order), np.asarray(jb.fin),
                           device="cpu")
    o, d = bunny_rays()
    pad = (-o.shape[0]) % rk.MBLOCK
    o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
    d = np.concatenate([d, np.ones((pad, 3), np.float32)])
    nj, wj, bj, _ = jax_rk._mxu_prep(jb, jnp.asarray(o), jnp.asarray(d),
                                     10.0, stream)
    nt, wt, bt, rays = rk._mxu_prep(pb, torch.from_numpy(o),
                                    torch.from_numpy(d), 10.0, stream)
    np.testing.assert_array_equal(np.asarray(nj).reshape(-1), nt.numpy())
    np.testing.assert_array_equal(np.asarray(wj)[:, 0], wt.numpy())
    if stream:
        np.testing.assert_array_equal(np.asarray(bj)[:, 0], bt.numpy())
    else:
        assert bt is None
    assert nt.sum() > 0
    assert rays.shape == (9, o.shape[0]) and rays.is_contiguous()


@pytest.mark.parametrize("structure", ["shared", "own"])
@pytest.mark.parametrize("edge_wildcard", [False, True])
@pytest.mark.parametrize("tier", ["resident", "stream"])
def test_cast_matches_jax(tier, edge_wildcard, structure):
    v, f = bunny_mesh()
    o, d = bunny_rays()
    mt = 32_000 if tier == "resident" else 0
    jrc = p3d.create_raycaster(v, f, backend="pallas", config=JaxConfig(
        mxu_max_tris=mt, edge_wildcard=edge_wildcard))
    prc = p3t.create_raycaster(v, f, backend="pallas", device="cpu",
                               config=RayCastConfig(
                                   mxu_max_tris=mt,
                                   edge_wildcard=edge_wildcard))
    assert prc.stream == (tier == "stream") == jrc.mxu_stream
    if structure == "shared":
        jb = jrc.cbvh
        prc.cbvh = from_jax_clusters(
            np.asarray(jb.boxes), np.asarray(jb.w2),
            np.asarray(jb.prim_order), np.asarray(jb.fin), device="cpu")
    assert_hits_agree(jrc.cast(o, d), prc.cast(o, d))


def _nearest_hit_f64(tris, ro, rd):
    """Face id of the nearest Möller-Trumbore hit in float64, or -1."""
    a = tris[:, 0].astype(np.float64)
    e1, e2 = tris[:, 1] - a, tris[:, 2] - a
    p = np.cross(rd, e2)
    det = np.sum(e1 * p, axis=1)
    inv = 1.0 / np.where(det == 0, 1e-300, det)
    s = ro - a
    u = np.sum(s * p, axis=1) * inv
    q = np.cross(s, e1)
    v = np.sum(rd * q, axis=1) * inv
    t = np.sum(e2 * q, axis=1) * inv
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0) & (det != 0)
    return int(np.nonzero(hit)[0][np.argmin(t[hit])]) if hit.any() else -1


def test_disagreements_are_double_bf16_misses():
    """Where the port's face id differs from the JAX caster's, the port's is
    the float64 nearest hit: the TPU's double-bf16 side products lose their
    sign on small triangles far from the ray origin (ROADMAP Queue 3)."""
    v, f = bunny_mesh()
    o, d = bunny_rays()
    want = p3d.create_raycaster(v, f, backend="pallas").cast(o, d).face_id
    got = p3t.create_raycaster(v, f, backend="pallas",
                               device="cpu").cast(o, d).face_id.numpy()
    diff = np.nonzero(np.asarray(want) != got)[0]
    assert len(diff) <= 0.005 * len(got)
    tris = v[f].astype(np.float64)
    for r in diff:
        assert got[r] == _nearest_hit_f64(tris, o[r].astype(np.float64),
                                          d[r].astype(np.float64))


@pytest.mark.parametrize("tier", ["resident", "stream"])
def test_whole_slice_matches_jax(tier):
    g = sphere()
    cam = jax_camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    mt = 32_000 if tier == "resident" else 0
    vj, fj = p3d.marching_cubes(g, 0.0, scale=(-1.0, 1.0))
    want = p3d.create_raycaster(vj, fj, backend="pallas",
                                config=JaxConfig(mxu_max_tris=mt)
                                ).cast(cam.origins, cam.dirs)
    vt, ft = p3t.marching_cubes(g, 0.0, scale=(-1.0, 1.0), device="cpu")
    prc = p3t.create_raycaster(vt, ft, backend="pallas", device="cpu",
                               config=RayCastConfig(mxu_max_tris=mt))
    assert prc.stream == (tier == "stream")
    assert_hits_agree(want, prc.cast(cam.origins, cam.dirs))


def test_plain_cast_is_the_cpu_path():
    """On CPU tensors the wrappers run the plain version, never a kernel."""
    v, f = bunny_mesh()
    o, d = bunny_rays()
    before = (rk.RESIDENT.launches, rk.STREAM.launches)
    bvh = build_mxu_clusters(torch.from_numpy(v[f]))
    depth, idx, finr = rk.cast_clusters_mxu(
        bvh, torch.from_numpy(o), torch.from_numpy(d), with_fin=True)
    assert (rk.RESIDENT.launches, rk.STREAM.launches) == before
    hit = idx >= 0
    assert depth.shape == idx.shape == (o.shape[0],)
    assert torch.all(depth[~hit] == 10.0) and torch.all(depth[hit] < 10.0)
    assert torch.all(finr[~hit] == 0)
    np.testing.assert_array_equal(
        finr[hit, 5].numpy(), bvh.prim_order[idx[hit].long()].numpy())
    d2, i2 = rk.cast_clusters_mxu(bvh, torch.from_numpy(o),
                                  torch.from_numpy(d), stream=True)
    assert torch.equal(i2, idx) and torch.equal(d2, depth)


def test_not_ported_backends_raise():
    """Nothing the JAX package accepts is refused any longer: the factory
    offers the JAX package's four backends and raises on an unknown one,
    and past the stream cap (here ``mxu_stream_max_tris=0``) the cluster
    caster takes the scalar-broadcast tier instead of raising."""
    v, f = np.eye(3, dtype=np.float32), np.array([[0, 1, 2]])
    with pytest.raises(ValueError, match="unknown backend"):
        p3t.create_raycaster(v, f, backend="optix", device="cpu")
    assert p3t.available_backends() == p3d.available_backends() == (
        "pallas", "mxu", "bvh", "bruteforce")
    rc = ClusterRayCaster(v, f, mxu_stream_max_tris=0, device="cpu")
    assert not rc.use_mxu and rc.cbvh.tri_data.shape == (1, 128, 9)
    hits = rc.cast(np.array([[0.2, 0.2, 1.0]], np.float32),
                   np.array([[0.0, 0.0, -1.0]], np.float32))
    assert hits.face_id.tolist() == [0]
    assert isinstance(p3t.create_raycaster(v, f, device="cpu"),
                      ClusterRayCaster)


def test_stream_tier_cluster_cap():
    bvh = build_mxu_clusters(torch.from_numpy(soup(T=16)))
    big = bvh._replace(boxes=torch.zeros((32768, 6)))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="32767"):
        rk.cast_clusters_mxu(big, o, torch.ones((4, 3)), stream=True)
