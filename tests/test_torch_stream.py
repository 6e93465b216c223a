"""The stream tier's work-list cull and the stream kernel's culls and exit
(CPU).

All run only on the card: the cull kernel ``csrc/stream_cull.cu`` and the
per-warp box cull, sub-box cull and early exit of ``cluster_cast_stream``
in ``csrc/cluster_cast.cu``. Here their plain versions are held to what
lets the kernels equal them (``tests/test_torch_cuda.py`` compares the
kernels with them on the card):

  * the work lists of ``work_lists_plain`` equal the JAX package's on a mesh
    whose cluster boxes are flat and axis-aligned, with rays from box planes
    (a NaN slab) and a zero entry bound whose products are -0.0; a zero
    bound is written as +0.0, and the unflagged tails are in index order;
  * the plain cast visits every listed cluster; the kernel skips a listed
    cluster for a ray when the cull finds that no ray of its warp enters the
    box or sub-box, or when its warp's best hits are all <= the entry's
    bound. Every listed (ray, cluster) pair with a hit passes the kernel's
    box cull and its nearest triangle's sub-box passes the sub-box cull
    (``_stream_box_enters``, the test in plain PyTorch), on the bunny, the
    icosphere with axis-parallel rays on box planes and the flat mesh, with
    and without ``edge_wildcard``; there no hit lies below its entry's
    bound, so the exit drops none and the kernel equals the plain version
    on every ray;
  * where a hit does lie below its bound (the card tests' bunny frame has
    one ray through a vertex, nearly in two triangles' planes), it is
    rounding noise by the float64 witness of ``cast_disputes``, which
    settles such a ray and refuses a ray where a real hit was dropped;
  * the resident kernel walks its pairs with the same two culls and no
    exit: every listed (ray, cluster) pair of the resident list with a hit
    passes the box cull, and every hit triangle's sub-box the sub-box cull
    (a later hit of the same t in list order must not lose to a skipped
    earlier one), or the hit is noise by the float64 witness.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu_torch as p3t
from primitive3d_tpu.kernels import raycast_kernel as jax_rk
from primitive3d_tpu_torch.bvh.clusters import build_mxu_clusters
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.render.camera import camera_rays
from tests.oracles.raycast_numpy import icosphere
from tests.stream_cases import (CULL_CASES, cull_case, flat_case, pad_rays,
                                rows)

from .test_torch_raycast import BUNNY, bunny_rays


@functools.cache
def ico_case():
    """The 1,280-face icosphere in Morton clusters of 16 under 2,500 rays
    from radius 3 and 64 axis-parallel rays from cluster box planes."""
    v, f = icosphere(3)
    tris = np.asarray(v, np.float32)[np.asarray(f)]
    bvh = build_mxu_clusters(torch.from_numpy(tris), cluster_size=16)
    rng = np.random.default_rng(0)
    o = rng.standard_normal((2500, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = rng.standard_normal((2500, 3)) * 0.6 - o
    bx = bvh.boxes.numpy()
    k = np.arange(64) % bx.shape[0]
    o_ap = np.stack([bx[k, 0], bx[k, 4], np.full(64, -3.0)], 1)
    o = np.concatenate([o, o_ap]).astype(np.float32)
    d = np.concatenate([d, np.tile([0.0, 0.0, 1.0], (64, 1))])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return bvh, *pad_rays(o, d)


@functools.cache
def bunny_case():
    v, f = p3t.marching_cubes(np.load(BUNNY), 0.0, scale=1.0, device="cpu")
    bvh = build_mxu_clusters(v[f.long()])
    return (bvh, *bunny_rays())


# built once per process: the tests only read them
CASES = {"bunny": bunny_case, "ico": ico_case,
         "flat": functools.cache(flat_case)}


def test_flat_boxes_lists_match_jax_and_zero_is_positive():
    """Whole rows of both tiers' lists against the JAX package's plain-XLA
    lists (bounds by value: XLA's max leaves a zero's sign to the
    backend); every zero bound is +0.0 (``torch.clamp(-0.0, min=0)`` keeps
    -0.0, and this case makes one); each row is its flagged entries, then
    the rest in index order (stream: word c << 16, bound 3e38)."""
    bvh, o, d = flat_case()
    boxes = bvh.boxes
    assert bool((boxes[:, 3:] == boxes[:, :3]).any(dim=1).all())  # flat
    rays = rows(o, d)
    n, entries, sbound = rk.work_lists(boxes, rays, 10.0, True)
    B = n.shape[0]
    rint = jax_rk._ray_intervals(jnp.asarray(o), jnp.asarray(d), B, rk.NCH,
                                 rk.RCHUNK)
    nj, ej, bj = jax_rk._stream_entries(jnp.asarray(boxes.numpy()), rint,
                                        10.0, rk.NCH)
    np.testing.assert_array_equal(np.asarray(nj).reshape(-1), n.numpy())
    np.testing.assert_array_equal(np.asarray(ej)[:, 0], entries.numpy())
    np.testing.assert_array_equal(np.asarray(bj)[:, 0], sbound.numpy())
    C = boxes.shape[0]
    zero = sbound == 0.0
    assert bool(zero.any()) and bool((sbound.view(torch.int32)[zero] == 0)
                                     .all())
    for b in range(B):
        nb = int(n[b])
        head = entries[b, :nb]
        assert bool(((head & 0xFFFF) > 0).all())
        sb, sc = sbound[b, :nb], head >> 16
        assert bool(((sb[1:] > sb[:-1])
                     | ((sb[1:] == sb[:-1]) & (sc[1:] > sc[:-1]))).all())
        rest = torch.tensor(sorted(set(range(C)) - set(
            (head >> 16).tolist())), dtype=torch.int32)
        assert torch.equal(entries[b, nb:], rest << 16)
        assert bool((sbound[b, nb:] == 3.0e38).all())
    nr, pairs, none = rk.work_lists(boxes, rays, 10.0, False)
    assert none is None and pairs.shape == (B, C * rk.NCH)
    for b in range(B):
        flagged = ((entries[b, :, None] >> torch.arange(rk.NCH)) & 1).bool()
        want = ((entries[b] >> 16).long()[:, None] * rk.NCH
                + torch.arange(rk.NCH))[flagged].sort().values
        assert int(nr[b]) == want.numel()
        assert torch.equal(pairs[b, :int(nr[b])].long(), want)
        tail = pairs[b, int(nr[b]):].long()
        assert bool((tail[1:] > tail[:-1]).all())


@pytest.mark.parametrize("case", CULL_CASES)
def test_cull_cases_match_jax(case):
    """``work_lists_plain`` against the JAX package's plain-XLA lists on the
    cases whose hazards the cull kernel's four-corner slab test must meet
    (tests/stream_cases.py ``cull_case``; the card tests hold the kernel to
    the same plain lists): n and the words or pairs exactly, the stream
    bounds by value (XLA's max leaves a zero's sign to the backend)."""
    boxes, o, d = cull_case(case)
    C = boxes.shape[0]
    rays = rows(o, d)
    bt = torch.from_numpy(boxes)
    jb = jnp.asarray(boxes)
    rint = jax_rk._ray_intervals(jnp.asarray(o), jnp.asarray(d), 1, rk.NCH,
                                 rk.RCHUNK)
    n, entries, sbound = rk.work_lists_plain(bt, rays, 10.0, True)
    nj, ej, bj = jax_rk._stream_entries(jb, rint, 10.0, rk.NCH)
    np.testing.assert_array_equal(np.asarray(nj).reshape(-1), n.numpy())
    np.testing.assert_array_equal(np.asarray(ej)[:, 0], entries.numpy())
    np.testing.assert_array_equal(np.asarray(bj)[:, 0], sbound.numpy())
    nr, pairs, none = rk.work_lists_plain(bt, rays, 10.0, False)
    nj, pj, _, _ = jax_rk._mxu_prep(
        types.SimpleNamespace(boxes=jb, num_clusters=C), jnp.asarray(o),
        jnp.asarray(d), 10.0, False)
    assert none is None
    np.testing.assert_array_equal(np.asarray(nj).reshape(-1), nr.numpy())
    np.testing.assert_array_equal(np.asarray(pj)[:, 0], pairs.numpy())
    flagged = int(n[0])
    if case == "none":
        assert flagged == 0 and int(nr[0]) == 0
    elif case == "all":
        assert flagged == C and int(nr[0]) == C * rk.NCH
    else:
        assert 0 < flagged < C and 0 < int(nr[0]) < C * rk.NCH


def listed_hits(bvh, o, d, edge_wildcard, max_dist=10.0):
    """Every listed (ray, cluster) pair of the stream tier with a hit below
    max_dist: ray, list position, cluster, nearest slot, quantised t and
    the entry's bound, each (P,); every listed pair's (ray, cluster); and
    the lists and ray rows."""
    rays = rows(o, d)
    n, entries, sbound = rk.work_lists(bvh.boxes, rays, max_dist, True)
    ray = torch.arange(rays.shape[1])
    blk, chunk = ray // rk.MBLOCK, (ray % rk.MBLOCK) // rk.RCHUNK
    listed = ((entries[blk] >> chunk[:, None]) & 1).bool()
    listed &= torch.arange(entries.shape[1]) < n[blk][:, None]
    r, e = listed.nonzero(as_tuple=True)
    c = (entries[blk[r], e] >> 16).long()
    S = bvh.cluster_size
    keys = torch.cat([rk._visit_keys(bvh.w[c[s:s + 4096]],
                                     rays[:, r[s:s + 4096]][:, :, None],
                                     edge_wildcard)[:, 0]
                      for s in range(0, r.shape[0], 4096)])
    t = (keys & ~(S - 1)).view(torch.float32)
    hit = t < max_dist
    pairs = dict(ray=r[hit], pos=e[hit], c=c[hit],
                 slot=(keys[hit] & (S - 1)).long(), t=t[hit],
                 bound=sbound[blk[r[hit]], e[hit]])
    return pairs, (r, c), (n, entries, sbound), rays


@pytest.mark.parametrize("edge_wildcard", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_box_cull_keeps_every_winner(case, edge_wildcard):
    """Every listed (ray, cluster) pair with a hit, each ray's winner among
    them, passes the stream kernel's box cull, and its nearest triangle's
    sub-box the sub-box cull, the coplanar rays of the icosphere and the
    cube included (a ray in a triangle's plane can win at t = 0 far ahead
    of the box, which is why the cull does not hold the entry t against
    the best hit); no hit lies below its entry's bound, so the warp's exit
    drops none; the cull drops most listed pairs, so it is not a no-op."""
    bvh, o, d = CASES[case]()
    P, (r_ix, c), (n, entries, sbound), rays = listed_hits(bvh, o, d,
                                                           edge_wildcard)
    depth, idx, _ = rk.cluster_cast_plain(n, entries, sbound, bvh.w, bvh.fin,
                                          rays, 10.0, edge_wildcard,
                                          with_fin=False)
    hit = idx >= 0
    assert 0.05 < float(hit.float().mean()) < 0.95
    # the winners are among the pairs
    win = torch.zeros_like(hit)
    win[P["ray"][(P["c"] * bvh.cluster_size + P["slot"])
                 == idx[P["ray"]].long()]] = True
    assert torch.equal(win, hit)
    ot, dt = torch.from_numpy(o)[P["ray"]], torch.from_numpy(d)[P["ray"]]
    kept = rk._stream_box_enters(bvh.boxes[P["c"]], ot, dt)
    assert bool(kept.all()), f"{int((~kept).sum())} hits culled"
    nsub = bvh.sub_boxes.shape[1]
    sub = P["slot"] // (bvh.cluster_size // nsub)
    kept = rk._stream_box_enters(bvh.sub_boxes[P["c"], sub], ot, dt)
    assert bool(kept.all()), f"{int((~kept).sum())} hits' sub-boxes culled"
    below = P["t"] < P["bound"]
    assert not bool(below.any()), f"{int(below.sum())} hits below the bound"
    # listed pairs the cull drops: most of each chunk's list
    enters = rk._stream_box_enters(bvh.boxes[c], torch.from_numpy(o)[r_ix],
                                   torch.from_numpy(d)[r_ix])
    assert 0.0 < float(enters.float().mean()) < 0.5


@pytest.mark.parametrize("edge_wildcard", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_resident_culls_keep_every_hit(case, edge_wildcard):
    """The resident list: every listed (ray, cluster) pair with a hit below
    max_dist passes the resident kernel's box cull, and every triangle of
    it with a hit, not only the nearest, its sub-box cull, or that hit is
    rounding noise by the float64 witness (``rk._witness``); the plain
    cast's winners are among those hits, and the cull drops most listed
    pairs."""
    bvh, o, d = CASES[case]()
    rays = rows(o, d)
    n, pairs, _ = rk.work_lists(bvh.boxes, rays, 10.0, False)
    S = bvh.cluster_size
    live = torch.arange(pairs.shape[1]) < n[:, None]
    blk, pos = live.nonzero(as_tuple=True)
    word = pairs[blk, pos]
    # every listed (ray, cluster) pair: a pair's chunk is 256 rays
    ray = ((blk * rk.MBLOCK + (word & (rk.NCH - 1)) * rk.RCHUNK)[:, None]
           + torch.arange(rk.RCHUNK)).reshape(-1)
    c = (word >> 3).long().repeat_interleave(rk.RCHUNK)
    hits = []
    for s in range(0, ray.shape[0], 2048):
        r, cc = ray[s:s + 2048], c[s:s + 2048]
        ok, t = rk._triangle_tests(bvh.w[cc], rays[:, r][:, :, None],
                                   edge_wildcard)
        tq = (torch.where(ok, t, 3.0e38).abs()[..., 0].view(torch.int32)
              & ~(S - 1)).view(torch.float32)
        p, slot = (tq < 10.0).nonzero(as_tuple=True)
        hits.append((r[p], cc[p], slot))
    hr, hc, hs = (torch.cat(x) for x in zip(*hits))
    _, idx, _ = rk.cluster_cast_plain(n, pairs, None, bvh.w, bvh.fin, rays,
                                      10.0, edge_wildcard, with_fin=False)
    hit = idx >= 0
    assert 0.05 < float(hit.float().mean()) < 0.95
    won = torch.zeros_like(hit)
    won[hr[(hc * S + hs) == idx[hr].long()]] = True
    assert torch.equal(won, hit)
    ot, dt = torch.from_numpy(o)[hr], torch.from_numpy(d)[hr]
    nsub = bvh.sub_boxes.shape[1]
    kept = (rk._stream_box_enters(bvh.boxes[hc], ot, dt)
            & rk._stream_box_enters(bvh.sub_boxes[hc, hs // (S // nsub)],
                                    ot, dt))
    q = (~kept).nonzero()[:, 0]
    if q.numel():  # a culled hit must be noise
        _, h, noise = rk._witness(bvh.w[hc[q]], rays[:, hr[q]][:, :, None],
                                  edge_wildcard, 10.0)
        at = torch.arange(q.numel())
        assert bool(h[at, hs[q], 0].all())
        assert bool(noise[at, hs[q], 0].all()), \
            f"{int((~noise[at, hs[q], 0]).sum())} real hits culled"
    enters = rk._stream_box_enters(bvh.boxes[c], torch.from_numpy(o)[ray],
                                   torch.from_numpy(d)[ray])
    assert 0.0 < float(enters.float().mean()) < 0.5


def test_exit_drops_only_noise():
    """The card tests' bunny frame (128 x 96 rays, clusters of 128): the
    hits that lie below their entry's bound, which a warp's exit may drop,
    are on one ray through a mesh vertex, and each is float32 noise: its
    test fails in float64 on the same rows, or gives a float64 t more than
    NOISE_REL away. ``cast_disputes`` settles that ray for a cast that
    keeps the nearest hit that is not noise, and refuses it for a cast that
    misses, as it refuses a hit ray turned into a miss."""
    v, f = p3t.marching_cubes(np.load(BUNNY), 0.0, scale=1.0, device="cpu")
    bvh = build_mxu_clusters(v[f.long()], cluster_size=128)
    cam = camera_rays(128, 96, origin=(0.43, 0.57, -1.5),
                      look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    o, d = pad_rays(cam.origins, cam.dirs)
    P, _, (n, entries, sbound), rays = listed_hits(bvh, o, d, False)
    want = rk.cluster_cast_plain(n, entries, sbound, bvh.w, bvh.fin, rays,
                                 10.0, with_fin=False)
    below = P["t"] < P["bound"]
    assert P["ray"][below].unique().tolist() == [1012]
    q, S = 1012, bvh.cluster_size
    # every triangle of the ray's listed clusters, in float32 and float64
    b, r = q // rk.MBLOCK, (q % rk.MBLOCK) // rk.RCHUNK
    live = (((entries[b] >> r) & 1).bool()
            & (torch.arange(entries.shape[1]) < n[b]))
    c = (entries[b][live] >> 16).long()
    ray = rays[:, q].reshape(9, 1, 1)
    ok, t = rk._triangle_tests(bvh.w[c], ray, False)
    tm = torch.where(ok, t, 3.0e38).abs()[..., 0]
    tq = (tm.view(torch.int32) & ~(S - 1)).view(torch.float32)
    ok64, t64 = rk._triangle_tests(bvh.w[c].double(), ray.double(), False)
    real = (tq < 10.0) & ok64[..., 0] & (
        (t64[..., 0].abs() - tm.double()).abs()
        <= rk.NOISE_REL * t64[..., 0].abs())
    for cb, sb in zip(P["c"][below].tolist(), P["slot"][below].tolist()):
        assert not bool(real[(c == cb).nonzero()[0, 0], sb])
    assert bool(real.any())
    k = int(torch.where(real, tq, float("inf")).reshape(-1).argmin())
    got = (want[0].clone(), want[1].clone())
    got[0][q] = tq.reshape(-1)[k]
    got[1][q] = int(c[k // S]) * S + k % S
    assert float(got[0][q]) > float(want[0][q])
    rq, settled, clean = rk.cast_disputes(n, entries, True, bvh.w, rays,
                                          10.0, False, got, want)
    assert rq.tolist() == [q] and bool(settled.all())
    assert torch.equal(clean, got[0][rq])
    # a miss there, or on a ray with a real hit, is not settled
    q2 = int((want[1] >= 0).nonzero()[0, 0])
    far = (got[0].clone(), got[1].clone())
    far[0][[q, q2]], far[1][[q, q2]] = 10.0, -1
    rq, settled, _ = rk.cast_disputes(n, entries, True, bvh.w, rays, 10.0,
                                      False, far, want)
    assert sorted(rq.tolist()) == sorted([q, q2])
    assert not bool(settled.any())
