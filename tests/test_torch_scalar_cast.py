"""Parity of the port's scalar-broadcast cluster tier with the JAX package
(CPU).

The JAX kernels ``_kernel_ordered`` and ``_kernel`` run as the JAX
package's own tests run them off the TPU (``cast_clusters(...,
interpret=True)``); the port runs their plain version on CPU tensors. Both
get the same numpy meshes and rays: a 1,280-face icosphere in clusters of 8
or 16 (3 or 5 groups of 32, so the order, the bounds and the early exit act),
2,500 rays at the sphere over three 1,024-ray blocks, and 64 axis-parallel
rays whose origins lie on cluster box planes (0 * inf in the slab test).

Tolerances: the cluster structures, orders and bounds are equal exactly.
Depth agrees to rtol 4e-6 (a few ulps: XLA may contract the kernels' cross
products into FMAs, the port rounds every product, and a grazing ray's
1 / det magnifies the difference; the largest seen is 1.5e-6). Face ids
are equal except at exact ties: axis-parallel rays through a shared vertex
or edge, where either triangle is the nearest and the two depths agree to
2e-7 relative; 5 (clusters of 8) and 2 (of 16) of the 2,564 rays, so the
test allows 0.5%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.bvh.clusters import build_clusters as jax_build
from primitive3d_tpu.core.config import RayCastConfig as JaxConfig
from primitive3d_tpu.kernels import raycast_kernel as jax_rk
from primitive3d_tpu_torch.bvh.clusters import (ClusterBVH, build_clusters,
                                                from_jax_cluster_bvh)
from primitive3d_tpu_torch.core.config import RayCastConfig
from primitive3d_tpu_torch.geometry.triangle import subdivide
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.render.camera import camera_rays
from tests.oracles.raycast_numpy import icosphere

from .test_torch_raycast import sphere

RTOL = 4e-6
SIZES = (8, 16)


def _rays(boxes):
    rng = np.random.default_rng(0)
    o = rng.standard_normal((2500, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = rng.standard_normal((2500, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # axis-parallel rays along +z from a box's lower x and upper y plane
    k = np.arange(64) % boxes.shape[0]
    o_ap = np.stack([boxes[k, 0], boxes[k, 4], np.full(64, -3.0)], 1)
    d_ap = np.tile([0.0, 0.0, 1.0], (64, 1))
    return (np.concatenate([o, o_ap]).astype(np.float32),
            np.concatenate([d, d_ap]).astype(np.float32))


@pytest.fixture(scope="module")
def case():
    """Per cluster size: the JAX structure, the rays, and the JAX casts
    (ordered and unordered), computed once."""
    v, f = icosphere(3)
    tris = np.asarray(v, np.float32)[np.asarray(f)]
    out = {}
    for cs in SIZES:
        jb = jax_build(jnp.asarray(tris), cluster_size=cs)
        o, d = _rays(np.asarray(jb.boxes))
        casts = {ordered: tuple(np.asarray(x) for x in jax_rk.cast_clusters(
            jb, jnp.asarray(o), jnp.asarray(d), interpret=True,
            ordered=ordered)) for ordered in (True, False)}
        out[cs] = dict(tris=tris, jb=jb, o=o, d=d, casts=casts)
    return out


def assert_ties_only(tj, ij, tt, it, max_share=0.005):
    """Ids equal except at exact ties; depth to RTOL everywhere."""
    np.testing.assert_allclose(tt, tj, rtol=RTOL, atol=0)
    diff = ij != it
    assert diff.mean() <= max_share
    np.testing.assert_allclose(tt[diff], tj[diff], rtol=2e-7, atol=0)
    assert np.all(diff[:2500] == 0)  # the generic rays agree on every id
    assert np.all((ij[diff] >= 0) & (it[diff] >= 0))


@pytest.mark.parametrize("cs", SIZES)
def test_clusters_and_order_match_jax(case, cs):
    c = case[cs]
    jb = c["jb"]
    tb = build_clusters(torch.from_numpy(c["tris"]), cluster_size=cs)
    for want, got in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    o = c["o"]
    o = np.concatenate([o, np.zeros(((-len(o)) % rk.RAY_BLOCK, 3),
                                    np.float32)])
    B = o.shape[0] // rk.RAY_BLOCK
    assert B == 3 and jb.boxes.shape[0] > 2 * rk.GROUP
    oj, gj = jax_rk._order_and_bounds(jb, jnp.asarray(o), B)
    ot, gt = rk._order_and_bounds(tb, torch.from_numpy(o), B)
    assert ot.dtype == torch.int32 and gt.shape == (B, -(-tb.boxes.shape[0]
                                                          // rk.GROUP))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("cs", SIZES)
def test_cast_clusters_matches_jax(case, cs, ordered):
    c = case[cs]
    tb = build_clusters(torch.from_numpy(c["tris"]), cluster_size=cs)
    before = (rk.SCALAR_ORDERED.launches, rk.SCALAR.launches)
    tt, it = rk.cast_clusters(tb, torch.from_numpy(c["o"]),
                              torch.from_numpy(c["d"]), ordered=ordered)
    # CPU tensors run the plain version, never a kernel
    assert (rk.SCALAR_ORDERED.launches, rk.SCALAR.launches) == before
    assert tt.shape == it.shape == (c["o"].shape[0],)
    tj, ij = c["casts"][ordered]
    assert 0.3 < np.mean(ij >= 0) < 0.95
    assert_ties_only(tj, ij, tt.numpy(), it.numpy())


@pytest.mark.parametrize("cs", SIZES)
def test_ordered_equals_unordered(case, cs):
    """As the JAX package's test of its two kernels: the same depth; ids
    equal but for exact ties."""
    c = case[cs]
    tb = build_clusters(torch.from_numpy(c["tris"]), cluster_size=cs)
    o, d = torch.from_numpy(c["o"]), torch.from_numpy(c["d"])
    t0, i0 = rk.cast_clusters(tb, o, d, ordered=True)
    t1, i1 = rk.cast_clusters(tb, o, d, ordered=False)
    np.testing.assert_allclose(t0.numpy(), t1.numpy(), rtol=0, atol=1e-6)
    assert float((i0 == i1).float().mean()) >= 0.99


def test_blocks_are_independent_and_exit_early(case):
    """The plain walk of a run of ray blocks equals those blocks of the
    whole cast, and a near bound stops a block's walk."""
    c = case[8]
    tb = from_jax_cluster_bvh(*c["jb"], device="cpu")
    pad = 3 * rk.RAY_BLOCK - c["o"].shape[0]
    o = torch.from_numpy(np.concatenate([c["o"], np.zeros((pad, 3))])
                         ).float()
    d = torch.from_numpy(np.concatenate([c["d"], np.ones((pad, 3))])).float()
    rays = torch.cat([o, d], dim=1).T.contiguous()
    order, gb = rk._order_and_bounds(tb, o, 3)
    depth, idx = rk.cluster_scalar_plain(order, gb, tb, rays, 10.0)
    sl = slice(rk.RAY_BLOCK, 3 * rk.RAY_BLOCK)
    d2, i2 = rk.cluster_scalar_ordered(order[1:], gb[1:], tb,
                                       rays[:, sl].contiguous(), 10.0)
    assert torch.equal(d2, depth[sl]) and torch.equal(i2, idx[sl])
    # bounds of 0 for the first group and max_dist after it: every block
    # walks one group only, so no ray finds more than the JAX kernel would
    # in its first 32 clusters
    gb_near = torch.full_like(gb, 10.0)
    gb_near[:, 0] = 0.0
    d3, i3 = rk.cluster_scalar_ordered(order, gb_near, tb, rays, 10.0)
    first = order[:, :rk.GROUP].repeat_interleave(rk.RAY_BLOCK, dim=0)
    hit = i3 >= 0
    assert hit.any() and (i3 != idx).any()
    assert bool((first[hit] == (i3[hit] // 8)[:, None]).any(dim=1).all())


def test_from_jax_cluster_bvh_feeds_the_cast(case):
    c = case[16]
    pb = from_jax_cluster_bvh(*(np.asarray(x) for x in c["jb"]),
                              device="cpu")
    assert all(t.is_contiguous() for t in pb)
    assert pb.prim_order.dtype == torch.int32
    tt, it = rk.cast_clusters(pb, torch.from_numpy(c["o"]),
                              torch.from_numpy(c["d"]))
    tj, ij = c["casts"][True]
    assert_ties_only(tj, ij, tt.numpy(), it.numpy())


def test_input_checks():
    tb = build_clusters(torch.rand(20, 3, 3), cluster_size=8)
    rays = torch.zeros((6, rk.RAY_BLOCK))
    with pytest.raises(ValueError, match="rays"):
        rk.cluster_scalar(tb, rays[:, :100], 10.0)
    with pytest.raises(ValueError, match="order"):
        rk.cluster_scalar_ordered(torch.zeros((1, 3), dtype=torch.int64),
                                  torch.zeros((1, 1)), tb, rays, 10.0)
    thin = ClusterBVH(torch.zeros((5, 6)), torch.zeros((5, 0, 6)),
                      torch.zeros((5, 4, 9)), torch.zeros(20, dtype=torch.int32))
    with pytest.raises(ValueError, match="S % 8"):
        rk.cluster_scalar_ordered(torch.zeros((1, 5), dtype=torch.int32),
                                  torch.zeros((1, 1)), thin, rays, 10.0)
    depth, idx = rk.cluster_scalar(thin, rays, 10.0)  # any S unordered
    assert torch.all(idx == -1) and torch.all(depth == 10.0)


def test_subdivide_child_order():
    """Twice subdivided, child i is a sixteenth of triangle i // 16: the
    children's areas are a sixteenth of their parent's, their centroids
    average to its centroid, and they lie in its plane."""
    v, f = icosphere(1)
    tris = torch.from_numpy(np.asarray(v, np.float32)[np.asarray(f)])
    kids = subdivide(subdivide(tris))
    assert kids.shape == (16 * tris.shape[0], 3, 3)
    parent = tris.repeat_interleave(16, dim=0)

    def area(t):
        n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], dim=-1)
        return n.norm(dim=-1) / 2

    torch.testing.assert_close(area(kids) * 16, area(parent), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(kids.mean(dim=1).view(-1, 16, 3).mean(dim=1),
                               tris.mean(dim=1), rtol=0, atol=1e-6)
    n = torch.linalg.cross(parent[:, 1] - parent[:, 0],
                           parent[:, 2] - parent[:, 0], dim=-1)
    off = ((kids - parent[:, :1]) * n[:, None]).sum(-1)
    assert float(off.abs().max()) <= 1e-6


# --- the tier on the casters' paths -----------------------------------------

@pytest.fixture(scope="module")
def sphere_mesh():
    """The 32^3 off-centre sphere's MC mesh and a 2,048-ray camera."""
    v, f = p3d.marching_cubes(sphere(), 0.0, scale=(-1.0, 1.0))
    cam = camera_rays(64, 32, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    return np.asarray(v), np.asarray(f), cam.origins, cam.dirs


def test_caster_scalar_tier_matches_jax(sphere_mesh):
    """``mxu_stream_max_tris=0`` takes the scalar-broadcast tier in both
    packages: depth (refined from the winner's plane) to 1e-6, normals to
    1e-6 and every face id equal."""
    v, f, o, d = sphere_mesh
    jrc = p3d.create_raycaster(v, f, backend="pallas", config=JaxConfig(
        mxu_stream_max_tris=0))
    prc = p3t.create_raycaster(v, f, backend="pallas", device="cpu",
                               config=RayCastConfig(mxu_stream_max_tris=0))
    assert not jrc.use_mxu and not prc.use_mxu
    assert isinstance(prc.cbvh, ClusterBVH)
    want, got = jrc.cast(o, d), prc.cast(o, d)
    fj = np.asarray(want.face_id)
    np.testing.assert_array_equal(got.face_id.numpy(), fj)
    assert 0.1 < np.mean(fj >= 0) < 0.9
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals),
                               rtol=0, atol=1e-6)
    # and the tier agrees with the port's resident tier
    res = p3t.create_raycaster(v, f, backend="pallas", device="cpu").cast(
        o, d)
    same = res.face_id == got.face_id
    assert float(same.float().mean()) >= 0.995
    torch.testing.assert_close(res.depth[same], got.depth[same], rtol=1e-6,
                               atol=1e-6)


def test_cast_clusters_diff_scalar_tier_matches_jax(sphere_mesh):
    """``cast_clusters_diff`` above ``mxu_stream_max_tris``: depth and prim
    against JAX, and the gradient of a depth loss with respect to the
    triangles against ``jax.vjp``: rtol 1e-5, atol 2e-5 x its largest entry,
    the bound of tests/test_torch_pipeline.py's test of the other tiers
    (grazing hits magnify rounding through t = num / den)."""
    v, f, o, d = sphere_mesh
    tris = v[f].astype(np.float32)
    cap = tris.shape[0] - 1
    w = np.random.default_rng(1).standard_normal(o.shape[0]).astype(
        np.float32)

    def jax_loss(t):
        depth, prim = jax_rk.cast_clusters_diff(
            t, jnp.asarray(o), jnp.asarray(d), interpret=True,
            mxu_stream_max_tris=cap)
        return jnp.sum(jnp.where(prim >= 0, depth, 0.0) * w), (depth, prim)

    lj, vjp_fn, (dj, pj) = jax.vjp(jax_loss, jnp.asarray(tris),
                                   has_aux=True)
    (grad_j,) = vjp_fn(jnp.ones_like(lj))
    t = torch.from_numpy(tris).requires_grad_()
    depth, prim = rk.cast_clusters_diff(t, torch.from_numpy(o),
                                        torch.from_numpy(d),
                                        mxu_stream_max_tris=cap)
    loss = torch.sum(torch.where(prim >= 0, depth, 0.0) * torch.from_numpy(w))
    loss.backward()
    np.testing.assert_array_equal(prim.numpy(), np.asarray(pj))
    assert 0.1 < float((prim >= 0).float().mean()) < 0.9
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(dj),
                               rtol=1e-6, atol=1e-6)
    gj = np.asarray(grad_j)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), gj, rtol=1e-5,
                               atol=2e-5 * np.abs(gj).max())
