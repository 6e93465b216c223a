"""Parity of the port's scalar-broadcast cluster tier with the JAX package
(CPU).

The JAX kernels ``_kernel_ordered`` and ``_kernel`` run as the JAX
package's own tests run them off the TPU (``cast_clusters(...,
interpret=True)``); the port runs their plain version on CPU tensors. Both
get the same numpy meshes and rays: a 1,280-face icosphere in clusters of 8
or 16 (3 or 5 groups of 32, so the order, the bounds and the early exit act),
2,500 rays at the sphere over three 1,024-ray blocks, and 64 axis-parallel
rays whose origins lie on cluster box planes (0 * inf in the slab test).

The port's own walk (a 32-wide box tree over the clusters, one warp per
ray on the card) is held against the index-order walk that the JAX
``_kernel`` does, bit for bit, on the same icosphere with axis-parallel
rays on cluster, sub-box and tree-node planes, on a mesh whose every
triangle appears twice, and on a mesh with a padded last cluster.

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
from primitive3d_tpu_torch.bvh.clusters import (TREE_WIDTH, ClusterBVH,
                                                build_cluster_tree,
                                                build_clusters,
                                                from_jax_cluster_bvh,
                                                tree_sizes)
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


def _walk_rays(bvh, tri=None):
    """Rays (6, R) for the walks: those of ``_rays``, then axis-parallel
    rays along +z whose origins lie on sub-box planes (32) and on the planes
    of the tree's level-1 boxes (32); with ``tri`` (3, 3), 64 rays last
    from outside the convex mesh at that triangle's centroid."""
    o, d = _rays(bvh.boxes.numpy())
    sb = bvh.sub_boxes.reshape(-1, 6).numpy()
    k = np.arange(32) * 7 % sb.shape[0]
    n = bvh.boxes.shape[0]
    lv = [bvh.boxes[s:s + TREE_WIDTH] for s in range(0, n, TREE_WIDTH)]
    lv = np.stack([np.concatenate([b[:, :3].amin(0).numpy(),
                                   b[:, 3:].amax(0).numpy()]) for b in lv])
    q = np.arange(32) % lv.shape[0]
    xy = [(0, 4), (3, 1), (0, 1), (3, 4)]
    planes = np.concatenate([
        np.stack([sb[k, 0], sb[k, 4]], 1),
        np.stack([lv[q[i], list(xy[i // 8])] for i in range(32)])])
    o = np.concatenate([o, np.concatenate([planes, np.full((64, 1), -3.0)],
                                          1)])
    d = np.concatenate([d, np.tile([0.0, 0.0, 1.0], (64, 1))])
    if tri is not None:
        c = tri.mean(0)
        nrm = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        nrm = nrm / np.linalg.norm(nrm) * np.sign(nrm @ c)  # outward
        jit = np.random.default_rng(2).standard_normal((64, 3)) * 0.05
        oc = c + 0.5 * nrm + jit - np.outer(jit @ nrm, nrm)
        dc = c - oc
        o = np.concatenate([o, oc])
        d = np.concatenate([d, dc / np.linalg.norm(dc, axis=1,
                                                   keepdims=True)])
    return torch.from_numpy(np.concatenate([o, d], 1).T.astype(np.float32)
                            ).contiguous()


@pytest.fixture(scope="module")
def walk():
    """Meshes for the walk's own tests, each with its tree and rays: the
    icosphere in clusters of 8 and 16, every triangle twice in clusters of
    16, and the first 1,277 triangles in clusters of 16 (the last cluster
    13 real and 3 padding slots) with rays at its last triangle."""
    v, f = icosphere(3)
    tris = np.asarray(v, np.float32)[np.asarray(f)]
    meshes = dict(ico8=(tris, 8), ico16=(tris, 16),
                  duplicated=(np.concatenate([tris, tris[::-1]]), 16),
                  padded=(tris[:1277], 16))
    out = {}
    for name, (t, cs) in meshes.items():
        tb = build_clusters(torch.from_numpy(t), cluster_size=cs)
        po = tb.prim_order
        last = (t[int(po[(po >= 0).nonzero().max()])] if name == "padded"
                else None)
        out[name] = (tb, build_cluster_tree(tb.boxes), _walk_rays(tb, last))
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
    """Both walks compute one function on these rays: the same depth and
    ids, bit for bit (the sub-box cull drops no winner here)."""
    c = case[cs]
    tb = build_clusters(torch.from_numpy(c["tris"]), cluster_size=cs)
    o, d = torch.from_numpy(c["o"]), torch.from_numpy(c["d"])
    t0, i0 = rk.cast_clusters(tb, o, d, ordered=True)
    t1, i1 = rk.cast_clusters(tb, o, d, ordered=False)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)


def test_blocks_are_independent_and_exit_early(walk):
    """Rays are independent: a run of the rays gives those rays' results.
    And a walk ends at its own depth: under a max_dist cut between the
    hits, a ray whose hit lies nearer keeps it, a ray whose hit lies beyond
    misses, and no ray's walk grows."""
    tb, tree, rays = walk["ico8"]
    R = rays.shape[1]
    counts = torch.zeros((R, 4), dtype=torch.int32)
    depth, idx = rk.cluster_scalar_plain(tree, tb, rays, 10.0, True, counts)
    sl = slice(R // 3, R - 7)
    d2, i2 = rk.cluster_scalar_ordered(tree, tb, rays[:, sl].contiguous(),
                                       10.0)
    assert torch.equal(d2, depth[sl]) and torch.equal(i2, idx[sl])
    cut = float(depth[idx >= 0].median())
    near = counts.new_zeros((R, 4))
    d3, i3 = rk.cluster_scalar_plain(tree, tb, rays, cut, True, near)
    kept = depth < cut
    assert kept.any() and (~kept & (idx >= 0)).any()
    assert torch.equal(d3[kept], depth[kept]) and torch.equal(i3[kept],
                                                              idx[kept])
    assert bool((i3[~kept] == -1).all()) and bool((d3[~kept] == cut).all())
    assert bool((near <= counts).all()) and bool((near < counts).any())


@pytest.mark.parametrize("C", [1, 31, 32, 33, 1025])
def test_cluster_tree_structure(C):
    """Each node's box is the union of its children's, the slots past a
    ragged node's children hold +inf boxes, and the level count is right:
    one level above the clusters at least, up to a single root."""
    rng = np.random.default_rng(C)
    lo = rng.standard_normal((C, 3)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rng.random((C, 3)).astype(np.float32)], 1))
    tree = build_cluster_tree(boxes)
    want = {1: (1, 1), 31: (31, 1), 32: (32, 1), 33: (33, 2, 1),
            1025: (1025, 33, 2, 1)}[C]
    assert tree.sizes == want == tree_sizes(C)
    assert tree.nodes.shape == (sum(want[1:]), 6, TREE_WIDTH)
    assert tree.nodes.is_contiguous()
    off = tree.offsets()
    level = boxes
    for k in range(1, len(want)):
        kids = tree.nodes[off[k]:off[k] + want[k]]  # (n_k, 6, W)
        flat = kids.transpose(1, 2).reshape(-1, 6)
        n = want[k - 1]
        assert torch.equal(flat[:n], level)
        assert bool(torch.isinf(flat[n:]).all() and (flat[n:] > 0).all())
        if k + 1 < len(want):
            parent = tree.nodes[off[k + 1]:off[k + 1] + want[k + 1]]
            level = parent.transpose(1, 2).reshape(-1, 6)[:want[k]]
        else:
            level = None
        union = torch.stack(
            [torch.stack([kids[i, a, :min(TREE_WIDTH, n - TREE_WIDTH * i)]
                          .amin() for a in range(3)]
                         + [kids[i, a, :min(TREE_WIDTH, n - TREE_WIDTH * i)]
                            .amax() for a in range(3, 6)])
             for i in range(want[k])])
        if level is not None:
            assert torch.equal(level, union)
        else:  # the root's box: the union of every cluster box
            assert torch.equal(union[0], torch.cat([boxes[:, :3].amin(0),
                                                    boxes[:, 3:].amax(0)]))
    with pytest.raises(ValueError, match="no clusters"):
        build_cluster_tree(boxes[:0])


@pytest.mark.parametrize("name", ["ico8", "ico16"])
def test_tree_keeps_every_cluster_the_flat_cull_keeps(walk, name):
    """Monotone rounding: wherever a ray's slab test enters a cluster box
    (at t < max_dist), it enters every box on the cluster's path to the
    root too, axis-parallel rays on box planes included."""
    tb, tree, rays = walk[name]
    R = rays.shape[1]
    o = [rays[a].view(1, 1, R) for a in range(3)]
    inv = [torch.reciprocal(rays[3 + a]).view(1, 1, R) for a in range(3)]
    ok = rk._slab_useful(tb.boxes[None], o, inv,
                         torch.full((1, 1, R), 10.0))[0]  # (C, R)
    assert ok.any(dim=0).float().mean() > 0.3
    off = tree.offsets()
    for k in range(1, len(tree.sizes)):
        boxes = tree.nodes[off[k]:off[k] + tree.sizes[k]].transpose(1, 2)
        boxes = boxes.reshape(-1, 6)[:tree.sizes[k - 1]]
        up = rk._slab_useful(boxes[None], o, inv,
                             torch.full((1, 1, R), 10.0))[0]
        assert bool((up[torch.arange(ok.shape[0]) // TREE_WIDTH ** (k - 1)]
                     | ~ok).all())


def _index_order_walk(bvh, o, d, max_dist=10.0):
    """The index-order walk of the JAX ``_kernel`` (and of this port before
    the tree): rays in blocks of 1,024 (padded with o = 0, d = 1), clusters
    in groups of 32 in index order; each ray culls a group's boxes with its
    best hit at the group's start (a NaN culls), every ray of the block
    tests all S triangles of each cluster that some ray of the block
    enters, and a strictly nearer hit replaces its best."""
    R = o.shape[0]
    pad = (-R) % rk.RAY_BLOCK
    o = torch.cat([o, torch.zeros((pad, 3))])
    d = torch.cat([d, torch.ones((pad, 3))])
    B = o.shape[0] // rk.RAY_BLOCK
    C, S = bvh.tri_data.shape[:2]
    ob = [o[:, a].view(B, 1, rk.RAY_BLOCK) for a in range(3)]
    db = [d[:, a].view(B, 1, rk.RAY_BLOCK) for a in range(3)]
    ib = [torch.reciprocal(x) for x in db]
    best = torch.full((B, rk.RAY_BLOCK), float(max_dist))
    bidx = torch.full((B, rk.RAY_BLOCK), -1, dtype=torch.int32)
    for g in range(0, C, rk.GROUP):
        bx = bvh.boxes[g:g + rk.GROUP]
        t0 = [(bx[None, :, a, None] - ob[a]) * ib[a] for a in range(3)]
        t1 = [(bx[None, :, a + 3, None] - ob[a]) * ib[a] for a in range(3)]
        lo = [torch.minimum(x, y) for x, y in zip(t0, t1)]
        hi = [torch.maximum(x, y) for x, y in zip(t0, t1)]
        tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
        tmax = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
        flags = ((tmin <= tmax) & (tmax >= 0.0)
                 & (tmin < best[:, None])).any(-1)  # (B, k)
        for j in flags.any(0).nonzero()[:, 0].tolist():
            c = g + j
            t = rk._triangle_t(bvh.tri_data[c][None], ob, db)
            t = torch.where(flags[:, j, None, None], t, float("inf"))
            tmin, m = t.min(dim=1)
            upd = tmin < best
            best = torch.where(upd, tmin, best)
            bidx = torch.where(upd, (c * S + m).to(torch.int32), bidx)
    return best.view(-1)[:R], bidx.view(-1)[:R]


@pytest.fixture(scope="module")
def index_walk(walk):
    """``_index_order_walk`` of each mesh of ``walk``, computed once per
    mesh: its result does not depend on ``ordered``."""
    cache = {}

    def get(name):
        if name not in cache:
            tb, _, rays = walk[name]
            cache[name] = _index_order_walk(tb, rays[:3].T, rays[3:].T)
        return cache[name]

    return get


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("name", ["ico8", "ico16", "duplicated", "padded"])
def test_plain_equals_index_order_walk(walk, index_walk, name, ordered):
    """The new plain version against the walk it replaces, bit for bit in
    depth and id: the icosphere's rays, axis-parallel rays on cluster,
    sub-box and tree-node planes, a mesh whose every triangle appears
    twice, and a mesh whose last cluster is padded, with rays at the last
    real triangle."""
    tb, tree, rays = walk[name]
    fn = rk.cluster_scalar_ordered if ordered else rk.cluster_scalar
    depth, idx = fn(tree, tb, rays, 10.0)
    want_d, want_i = index_walk(name)
    assert 0.3 < float((idx >= 0).float().mean()) < 0.95
    assert torch.equal(depth, want_d) and torch.equal(idx, want_i)


def test_ties_go_to_the_smallest_index(walk):
    """Every triangle twice: each hit takes the first copy (the smaller
    sorted index); a padded last cluster: rays at its last real triangle
    hit it, never a padding slot (prim_order -1) that repeats it."""
    tb, tree, rays = walk["duplicated"]
    _, idx = rk.cast_clusters(tb, rays[:3].T, rays[3:].T, tree=tree)
    T = tb.prim_order.shape[0] // 2  # no padding: 2,560 = 160 * 16
    prim = tb.prim_order[idx[idx >= 0].long()]
    assert prim.numel() > 1000 and bool((prim < T).all())
    tb, tree, rays = walk["padded"]
    n_at = 64
    _, idx = rk.cast_clusters(tb, rays[:3, -n_at:].T, rays[3:, -n_at:].T)
    last = int((tb.prim_order >= 0).nonzero().max())
    assert int((tb.prim_order < 0).sum()) == 3
    assert bool((idx == last).all())


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
    tree = build_cluster_tree(tb.boxes)
    rays = torch.zeros((6, 100))
    with pytest.raises(ValueError, match="rays"):
        rk.cluster_scalar(tree, tb, rays[:5], 10.0)
    with pytest.raises(ValueError, match="tree"):
        rk.cluster_scalar_ordered(build_cluster_tree(tb.boxes[:2]), tb,
                                  rays, 10.0)
    with pytest.raises(ValueError, match="counts"):
        rk.cluster_scalar(tree, tb, rays, 10.0,
                          counts=torch.zeros((100, 3), dtype=torch.int32))
    thin = ClusterBVH(torch.zeros((5, 6)), torch.zeros((5, 0, 6)),
                      torch.zeros((5, 4, 9)), torch.zeros(20, dtype=torch.int32))
    tree = build_cluster_tree(thin.boxes)
    with pytest.raises(ValueError, match="S % 8"):
        rk.cluster_scalar_ordered(tree, thin, rays, 10.0)
    depth, idx = rk.cluster_scalar(tree, thin, rays, 10.0)  # any S unordered
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
