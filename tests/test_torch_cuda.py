"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and skips without one. On a
machine with a card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The mask, cull, cast and scalar-broadcast kernels repeat the plain
versions' arithmetic in the same order with no FMA contraction, so masks,
work lists and casts are compared exactly (the lists' bounds bit for bit).
The
plane scatter kernel sums each row in float32 in ray order where its plain
version sums in float64: it is compared to a relative error of 1e-5, and
with itself bit for bit. The marching-tetrahedra, PLY and native tests
hold plain PyTorch on the card against the CPU (integers exactly,
positions to 1e-6, gradients to rtol 1e-5 / atol 1e-6), the lattice tier
against the sort tier, and a host-built tree walked on the card.
"""
import os

import numpy as np
import pytest
import torch

import primitive3d_tpu_torch as p3t
from primitive3d_tpu_torch import native
from primitive3d_tpu_torch.bvh.clusters import (build_cluster_tree,
                                                build_clusters,
                                                build_mxu_clusters)
from primitive3d_tpu_torch.bvh.traverse import cast_rays
from primitive3d_tpu_torch.core.config import RayCastConfig
from primitive3d_tpu_torch.geometry.triangle import subdivide
from primitive3d_tpu_torch.kernels import _build
from primitive3d_tpu_torch.kernels import mc_masks as mk
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.raycast import ClusterRayCaster
from primitive3d_tpu_torch.render.camera import camera_rays
from tests.mask_cases import special_grid
from tests.stream_cases import CULL_CASES, cull_case, flat_case, rows

BUNNY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data", "bunny.npy")
TETS = os.path.join(os.path.dirname(BUNNY), "tetrahedra")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 2, 2), (20, 23, 29), (66, 66, 66),
                                   (2, 3, 66), (5, 2, 3), (3, 7, 17),
                                   (9, 70, 33), (3, 512, 512), (4, 3, 4099),
                                   (200, 100, 101), (130, 96, 128)])
def test_masks_kernel_matches_plain(cuda, shape):
    """Equal masks over two launches, at shapes the kernel's tiling finds
    hard: X, Y or Z of 2, rows of Z - 1 bytes that are not a multiple of 4,
    Z < 16, tiles of many rows, a 512-wide slice (tiles of a few rows),
    rows longer than one tile's 4096 loaded cells, and grids too large for
    one-slice blocks (several slices a block, with scalar and with 16-byte
    loads); values at the threshold, +-inf and NaN."""
    grid = torch.from_numpy(special_grid(shape, 0.1, sum(shape))).to(cuda)
    before = mk.KERNEL.launches
    got = mk.fused_masks(grid, 0.1)
    again = mk.fused_masks(grid, 0.1)
    torch.cuda.synchronize()
    assert mk.KERNEL.launches == before + 2
    for g, a, w in zip(got, again, mk.fused_masks_plain(grid, 0.1)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("edge_wildcard", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_cast_kernels_match_plain(cuda, stream, edge_wildcard, S):
    """Depth, index and finish rows equal the plain version's on every
    ray (on this frame no hit that the kernels' culls or the stream
    kernel's exit may drop can win: tests/test_torch_stream.py); each
    kernel's walks reach at most the listed entries of their chunk (the
    resident walks, which have no exit, all of them) and test at most
    those, and the sub-box cull tests at most S / 8 sub-boxes a cluster."""
    v, f = p3t.marching_cubes(np.load(BUNNY), 0.0, scale=1.0)
    rc = p3t.create_raycaster(v, f, config=RayCastConfig(
        mxu_max_tris=0 if stream else 32_000, edge_wildcard=edge_wildcard,
        cluster_size=S))
    assert rc.cbvh.cluster_size == S
    cam = camera_rays(128, 96, origin=(0.43, 0.57, -1.5),
                      look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    o = torch.from_numpy(cam.origins).to(cuda)
    d = torch.from_numpy(cam.dirs).to(cuda)
    pad = (-o.shape[0]) % rk.MBLOCK
    o = torch.cat([o, torch.zeros((pad, 3), device=cuda)])
    d = torch.cat([d, torch.ones((pad, 3), device=cuda)])
    n, work, bounds, rays = rk._mxu_prep(rc.cbvh, o, d, 10.0, stream)
    kern, fn = ((rk.STREAM, rk.cluster_cast_stream) if stream
                else (rk.RESIDENT, rk.cluster_cast_resident))
    args = (n, work) + ((bounds,) if stream else ()) + (
        rc.cbvh.w, rc.cbvh.fin, rays, 10.0, edge_wildcard)
    kw = dict(boxes=rc.cbvh.boxes, sub_boxes=rc.cbvh.sub_boxes)
    before = kern.launches
    visits = torch.zeros((n.shape[0] * rk.NCH, 3), dtype=torch.int32,
                         device=cuda)
    got = fn(*args, visits=visits, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = rk.cluster_cast_plain(n, work, bounds, rc.cbvh.w, rc.cbvh.fin,
                                 rays, 10.0, edge_wildcard)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(visits.sum()) > 0
    # per chunk: tested <= reached <= its listed entries for each walk,
    # sub-boxes tested <= S / 8 per cluster tested
    chunks = torch.arange(rk.NCH, device=cuda)
    if stream:
        listed = (work[:, :, None] >> chunks) & 1
    else:
        listed = ((work[:, :, None] & (rk.NCH - 1)) == chunks).int()
    live = torch.arange(work.shape[1], device=cuda)[None, :] < n[:, None]
    per_chunk = (listed * live[:, :, None]).sum(dim=1).reshape(-1)
    walks = rk.RCHUNK // rk.STREAM_WALK
    assert bool((visits[:, 1] <= visits[:, 0]).all())
    if stream:
        assert bool((visits[:, 0] <= per_chunk * walks).all())
    else:  # no exit: every walk reaches every pair of its chunk
        assert torch.equal(visits[:, 0], per_chunk.int() * walks)
    assert int(visits[:, 1].sum()) < int(visits[:, 0].sum())
    assert bool((visits[:, 2] <= visits[:, 1] * (S // 8)).all())
    assert int(visits[:, 2].sum()) < int(visits[:, 1].sum()) * (S // 8)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mesh", ["bunny", "flat", *CULL_CASES, "C1", "C257",
                                  "C32767"])
def test_cull_kernel_matches_plain(cuda, mesh, stream):
    """The cull kernel's (n, work, bounds) equal the plain lists bit for
    bit over two launches (the bounds as int32 bits: a zero is +0.0 in
    both): on the bunny under 128x96 rays; on the cube of flat cluster
    boxes with rays from box planes and a zero bound
    (tests/test_torch_stream.py), where the stream cast then equals its
    plain version; on tests/stream_cases.py's ``cull_case`` hazards of the
    four-corner slab test (directions straddling zero, zero direction
    components, coordinates at +-1e37 and +-3e38, degenerate boxes, NaN,
    rows with nothing and with everything flagged); and at C = 1, 257 and
    32,767 clusters (the stream tier's largest, its shared memory near a
    block's limit) with more than 256 flagged keys a row (the sort's
    bitonic path)."""
    if mesh == "bunny":
        v, f = p3t.marching_cubes(np.load(BUNNY), 0.0, scale=1.0)
        bvh = build_mxu_clusters(v[f.long()])
        cam = camera_rays(128, 96, origin=(0.43, 0.57, -1.5),
                          look_at=(0.5, 0.5, 0.5), fov_y=35.0)
        o, d = cam.origins, cam.dirs
        pad = (-o.shape[0]) % rk.MBLOCK
        o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
        d = np.concatenate([d, np.ones((pad, 3), np.float32)])
        boxes = bvh.boxes
    elif mesh == "flat":
        bvh, o, d = flat_case()
        bvh = type(bvh)(*(t.to(cuda) for t in bvh))
        boxes = bvh.boxes
    else:
        C = int(mesh[1:]) if mesh.startswith("C") else 96
        case = "straddle" if mesh.startswith("C") else mesh
        bx, o, d = cull_case(case, C=C, seed=C)
        if mesh.startswith("C"):  # the first box in front of the rays
            bx[0, [2, 5]] += 10.0
        if mesh == "C32767":  # boxes that most chunks enter
            bx[:, 3:] += 2.0
        boxes = torch.from_numpy(bx).to(cuda)
    rays = rows(o, d).to(cuda)
    before = rk.CULL.launches
    got = rk.work_lists(boxes, rays, 10.0, stream)
    again = rk.work_lists(boxes, rays, 10.0, stream)
    torch.cuda.synchronize()
    assert rk.CULL.launches == before + 2
    want = rk.work_lists_plain(boxes, rays, 10.0, stream)
    for g in (got, again):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
        if stream:
            assert torch.equal(g[2].view(torch.int32),
                               want[2].view(torch.int32))
        else:
            assert g[2] is None and want[2] is None
    if stream:
        assert bool((want[2] == 0).any()) or mesh != "flat"
    if mesh == "none":
        assert int(got[0].sum()) == 0
    else:
        assert int(got[0].sum()) > 0
    if mesh == "C32767" and stream:
        assert int(got[0].max()) > 256
    if stream and mesh == "flat":
        n, entries, sbound = got
        out = rk.cluster_cast_stream(n, entries, sbound, bvh.w, bvh.fin,
                                     rays, 10.0, boxes=bvh.boxes,
                                     sub_boxes=bvh.sub_boxes)
        ref = rk.cluster_cast_plain(n, entries, sbound, bvh.w, bvh.fin,
                                    rays, 10.0)
        for g, w in zip(out, ref):
            assert torch.equal(g, w)


@pytest.mark.parametrize("tier", [32_000, 0])
def test_whole_slice_card_equals_cpu(cuda, tier):
    ax = np.linspace(-1.0, 1.0, 32).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    g = (np.float32(0.6) - np.sqrt((x - 0.13) ** 2 + (y + 0.07) ** 2
                                   + (z - 0.05) ** 2)).astype(np.float32)
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    outs = []
    for device in ("cuda", "cpu"):
        v, f = p3t.marching_cubes(g, 0.0, scale=(-1.0, 1.0), device=device)
        rc = p3t.create_raycaster(v, f, device=device,
                                  config=RayCastConfig(mxu_max_tris=tier))
        outs.append([t.cpu() for t in (v, f, *rc.cast(cam.origins,
                                                      cam.dirs))])
    (vc, fc, dc, nc, ic), (vh, fh, dh, nh, ih) = outs
    assert torch.equal(fc, fh) and torch.allclose(vc, vh, rtol=0, atol=1e-6)
    assert torch.equal(ic, ih)
    assert torch.allclose(dc, dh, rtol=1e-6, atol=1e-6)
    assert torch.allclose(nc, nh, rtol=0, atol=1e-6)


def _sphere(n=32):
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(0.6) - np.sqrt((x - 0.13) ** 2 + (y + 0.07) ** 2
                                      + (z - 0.05) ** 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["small", "mid", "unflagged", "long",
                                  "s256"])
def test_plane_scatter_kernel_matches_plain(cuda, case):
    """On a real stream list: the sphere soup under 64x64 rays (small), the
    bunny soup under 512x512 rays (mid); the small case with one ray's
    winner moved to a cluster its chunk is not flagged for, which adds
    nothing (unflagged); the sphere soup behind one large triangle that
    wins thousands of rays of a 128x128 frame, a long run of one row
    (long); the sphere soup in clusters of 256 (s256). Equal bits over two
    launches, and relative error 1e-5 against the float64 plain version."""
    box = dict(lower=(-1, -1, -1), upper=(1, 1, 1))
    grid, cap, S = _sphere(), 8192, 128
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    if case == "mid":
        grid, cap, box = np.load(BUNNY), 32768, dict(lower=(0, 0, 0),
                                                     upper=(1, 1, 1))
        cam = camera_rays(512, 512, origin=(0.5, 0.5, -1.5),
                          look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    elif case == "long":
        cam = camera_rays(128, 128, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    elif case == "s256":
        S = 256
    soup = p3t.marching_cubes_soup(grid, 0.0, face_capacity=cap, **box).soup
    if case == "long":
        big = torch.tensor([[[-0.3, -0.3, 0.9], [0.5, -0.3, 0.9],
                             [0.1, 0.6, 0.9]]])
        soup = torch.cat([soup, big.to(soup)])
    bvh = build_mxu_clusters(soup.to(cuda), cluster_size=S,
                             order="identity")
    o = torch.from_numpy(cam.origins).to(cuda)
    d = torch.from_numpy(cam.dirs).to(cuda)
    (_, sidx, _), (n, entries) = rk._cast_with_list(bvh, o, d, 10.0, True,
                                                    True, False)
    Rp = n.shape[0] * rk.MBLOCK
    widx = torch.full((Rp,), -1, dtype=torch.int32, device=cuda)
    widx[:sidx.shape[0]] = sidx
    assert int((widx >= 0).sum()) > 100
    C = bvh.num_clusters
    if case == "long":
        assert int((widx == soup.shape[0] - 1).sum()) >= 2000
    if case == "unflagged":
        cm = rk._cluster_masks(n, entries, C)
        r = int((widx >= 0).nonzero()[0, 0])
        b, ch = r // rk.MBLOCK, (r % rk.MBLOCK) // rk.RCHUNK
        widx[r] = int((((cm[:, b] >> ch) & 1) == 0).nonzero()[0, 0]) * S + 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn((Rp, 4), generator=gen, device=cuda)
    before = rk.PLANE_SCATTER.launches
    got = rk.plane_scatter(g, widx, n, entries, C, S)
    again = rk.plane_scatter(g, widx, n, entries, C, S)
    torch.cuda.synchronize()
    assert rk.PLANE_SCATTER.launches == before + 2
    assert torch.equal(got, again)
    want = rk.plane_scatter_plain(g, widx, n, entries, C, S)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5 and float(want.abs().max()) > 0
    if case == "unflagged":  # the moved ray adds nothing
        g[r] = 0.0
        assert torch.equal(got, rk.plane_scatter(g, widx, n, entries, C, S))


@pytest.mark.parametrize("case", ["pallas-32000", "pallas-0", "mxu"])
def test_training_step_card_equals_cpu(cuda, case, monkeypatch):
    """One SDF-fitting step on the 32^3 off-centre sphere: face ids and
    the cluster cast's depth equal (its 3-term sums are written out, so both
    devices round alike), loss to rtol 1e-6, density gradient to rtol 1e-5
    / atol 1e-6 x its largest entry (sums in another order on the card)."""
    backend, _, cap = case.partition("-")
    if cap:
        monkeypatch.setattr(ClusterRayCaster, "MXU_MAX_TRIS", int(cap))
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    kw = dict(vert_capacity=4096, face_capacity=8192, lower=(-1, -1, -1),
              upper=(1, 1, 1), max_dist=10.0, backend=backend)
    target = np.full(cam.origins.shape[0], 1.7, np.float32)
    outs = []
    for device in ("cuda", "cpu"):
        dens = torch.from_numpy(_sphere()).to(device).requires_grad_()
        loss = p3t.sdf_fitting_loss(dens, cam.origins, cam.dirs, target,
                                    device=device, **kw)
        loss.backward()
        soup = p3t.marching_cubes_soup(dens.detach(), 0.0,
                                       face_capacity=8192,
                                       lower=kw["lower"], upper=kw["upper"],
                                       device=device)
        depth, fid = rk.cast_clusters_diff(
            soup.soup, torch.from_numpy(cam.origins).to(device),
            torch.from_numpy(cam.dirs).to(device))
        outs.append((loss.item(), dens.grad.cpu(), fid.cpu(),
                     depth.detach().cpu()))
    (lc, gc, fc, dc), (lh, gh, fh, dh) = outs
    assert torch.equal(fc, fh) and torch.equal(dc, dh)
    assert lc == pytest.approx(lh, rel=1e-6)
    torch.testing.assert_close(gc, gh, rtol=1e-5,
                               atol=1e-6 * float(gh.abs().max()))


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("ordered", [True, False])
def test_scalar_kernels_match_plain(cuda, ordered, S):
    """The bunny subdivided once with its first 5,000 triangles repeated
    (111,240 triangles: 870 clusters of 128 or 435 of 256, neither a
    multiple of 32) under 128x96 rays plus axis-parallel rays from the
    planes of cluster boxes, sub-boxes and level-1 tree boxes (0 * inf in
    the slab test): the kernel equals its plain version bit for bit in
    depth and id, and its counts are those of a walk that prunes the plain
    version's walk."""
    v, f = p3t.marching_cubes(np.load(BUNNY), 0.0, scale=1.0, device=cuda)
    tris = subdivide(v[f.long()])
    tris = torch.cat([tris, tris[:5000]])
    bvh = build_clusters(tris, cluster_size=S)
    tree = build_cluster_tree(bvh.boxes)
    assert bvh.num_clusters % 32 != 0 and len(tree.sizes) == 3
    cam = camera_rays(128, 96, origin=(0.43, 0.57, -1.5),
                      look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    lv1 = tree.nodes[tree.offsets()[2]:].transpose(1, 2).reshape(-1, 6)
    planes = [bvh.boxes, bvh.sub_boxes.reshape(-1, 6), lv1[:tree.sizes[1]]]
    o_ap = []
    for bx in planes:
        k = torch.arange(512, device=cuda) * 7 % bx.shape[0]
        o_ap.append(torch.stack([bx[k, 0], bx[k, 4],
                                 torch.full_like(bx[k, 0], -1.0)], 1))
    o = torch.cat([torch.from_numpy(cam.origins).to(cuda), *o_ap])
    d = torch.cat([torch.from_numpy(cam.dirs).to(cuda),
                   torch.tensor([0.0, 0.0, 1.0], device=cuda).expand(1536, 3)])
    rays = torch.cat([o, d], dim=1).T.contiguous()
    R = rays.shape[1]
    kern, fn = ((rk.SCALAR_ORDERED, rk.cluster_scalar_ordered) if ordered
                else (rk.SCALAR, rk.cluster_scalar))
    counts = torch.zeros((R, 4), dtype=torch.int32, device=cuda)
    before = kern.launches
    got = fn(tree, bvh, rays, 10.0, counts=counts)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    full = torch.zeros_like(counts)
    want = rk.cluster_scalar_plain(tree, bvh, rays, 10.0, ordered, full)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0.05 < float((got[1] >= 0).float().mean()) < 0.95
    assert bool((counts <= full).all()) and bool((counts[:, 0] >= 1).all())
    nodes, boxes, subs, tested = counts.long().unbind(1)
    assert bool((boxes <= nodes * 32).all())
    if ordered:
        assert bool((subs % (S // 8) == 0).all() and (tested % 8 == 0).all())
        assert bool((tested <= subs // (S // 8) * S).all())
    else:
        assert bool((subs == 0).all() and (tested % S == 0).all())


@pytest.mark.parametrize("backend", ["pallas-scalar", "mxu", "bruteforce",
                                     "bvh"])
def test_backends_card_equals_cpu(cuda, backend):
    """Each caster on the 32^3 off-centre sphere: card against CPU. The
    scalar tier and the brute force round every product in written-out
    order on both, so ids and depth are equal; the all-pairs matrix
    product sums in another order on the card, so its ids agree on 99.9%
    and depth to 1e-5; the LBVH build and walk are exact integer and
    written-out float work."""
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    cfg = RayCastConfig(mxu_stream_max_tris=0)
    outs = []
    for device in ("cuda", "cpu"):
        v, f = p3t.marching_cubes(_sphere(), 0.0, scale=(-1.0, 1.0),
                                  device=device)
        rc = p3t.create_raycaster(v, f, backend=backend.split("-")[0],
                                  config=cfg, device=device)
        outs.append([t.cpu() for t in rc.cast(cam.origins, cam.dirs)])
    (dc, nc, ic), (dh, nh, ih) = outs
    assert 0.1 < float((ih >= 0).float().mean()) < 0.9
    if backend == "mxu":
        same = ic == ih
        assert float(same.float().mean()) >= 0.999
        assert torch.allclose(dc[same], dh[same], rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(ic, ih)
        assert torch.allclose(dc, dh, rtol=1e-6, atol=1e-6)
        assert torch.allclose(nc, nh, rtol=0, atol=1e-6)


def test_build_all_sources(cuda):
    logs = _build.build()
    assert set(_build.sources()) == {"cluster_cast.cu", "cluster_scalar.cu",
                                     "mc_masks.cu", "plane_scatter.cu",
                                     "stream_cull.cu"}
    assert all(isinstance(text, str) for text in logs.values())


def _mt_fixture():
    return [np.load(os.path.join(TETS, f"{name}.npy"))
            for name in ("points", "tetrahedras", "sdfs")]


def test_mt_fixture_card_equals_cpu(cuda):
    """Eager marching tetrahedra on the tet fixture: faces, tet ids and
    counts equal, positions to 1e-6, and the gradient of sum(v ** 2) with
    respect to the points and the SDF to rtol 1e-5 / atol 1e-6 (autograd's
    scatter-adds may sum in another order on the card)."""
    pts, tets, sdf = _mt_fixture()
    outs = []
    for device in ("cuda", "cpu"):
        p = torch.from_numpy(pts).to(device).requires_grad_()
        s = torch.from_numpy(sdf).to(device).requires_grad_()
        v, f, tid = p3t.marching_tetrahedra(p, tets, s, return_tet_idx=True,
                                            device=device)
        (v ** 2).sum().backward()
        outs.append([t.detach().cpu() for t in (v, f, tid, p.grad, s.grad)])
    (vc, fc, tc, gpc, gsc), (vh, fh, th, gph, gsh) = outs
    assert (vc.shape[0], fc.shape[0]) == (4650, 9296)
    assert torch.equal(fc, fh) and torch.equal(tc, th)
    assert torch.allclose(vc, vh, rtol=1e-6, atol=1e-6)
    assert torch.allclose(gpc, gph, rtol=1e-5, atol=1e-6)
    assert torch.allclose(gsc, gsh, rtol=1e-5, atol=1e-6)


def test_mt_lattice_equals_sort_tier_on_card(cuda):
    """At n = 24 on the card: the lattice tier, with the points and without,
    against the sort tier on grid_tetrahedra(24)."""
    n = 24
    pts, tets = p3t.grid_tetrahedra(n)
    sdf = ((n / 4.0) - np.linalg.norm(pts - (n - 1) / 2.0, axis=1)
           ).astype(np.float32)
    kw = dict(vert_capacity=8192, face_capacity=16384)
    want = p3t.marching_tetrahedra_padded(pts, tets, sdf, **kw)
    assert 0 < int(want.num_faces) <= 16384
    for vin in (pts, None):
        got = p3t.marching_tetrahedra_lattice(vin, sdf, n, **kw)
        for name in ("faces", "tet_idx", "num_vertices", "num_faces"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.allclose(got.vertices, want.vertices, rtol=1e-6,
                              atol=1e-6)


def test_save_mesh_from_cuda_tensors(cuda, tmp_path):
    pts, tets, sdf = _mt_fixture()
    v, f = p3t.marching_tetrahedra(pts, tets, sdf)
    assert v.is_cuda and f.is_cuda
    p3t.save_mesh(v, f, filename=tmp_path / "card.ply")
    p3t.save_mesh(v.cpu().numpy(), f.cpu().numpy(),
                  filename=tmp_path / "host.ply")
    assert (tmp_path / "card.ply").read_bytes() == \
        (tmp_path / "host.ply").read_bytes()
    v2, f2, _ = p3t.load_mesh(tmp_path / "card.ply")
    assert np.array_equal(v2, v.cpu().numpy())
    assert np.array_equal(f2, f.cpu().numpy())


def test_native_tree_walked_on_card(cuda):
    """A tree built on the host by the native runtime, walked on the card by
    ``bvh.traverse.cast_rays``: the same hits as the walk on the CPU and
    as the native cast."""
    v, f = p3t.marching_cubes(_sphere(), 0.0, scale=(-1.0, 1.0),
                              device="cpu")
    tris = v[f.long()]
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    o, d = torch.from_numpy(cam.origins), torch.from_numpy(cam.dirs)
    walks = []
    for device in ("cuda", "cpu"):
        bvh = native.build_lbvh(tris, device=device)
        assert bvh.left.device.type == device
        depth, leaf = cast_rays(bvh, o.to(device), d.to(device), 10.0)
        fid = torch.where(leaf >= 0,
                          bvh.prim_order[leaf.clamp(min=0).long()], -1)
        walks.append((depth.cpu(), fid.cpu()))
    (dc, ic), (dh, ih) = walks
    assert torch.equal(ic, ih) and torch.allclose(dc, dh, rtol=1e-6,
                                                  atol=1e-6)
    _, _, nid = native.raycast(bvh, o, d, 10.0)
    assert 0.1 < float((ic >= 0).float().mean()) < 0.9
    assert float((ic.numpy() == nid).mean()) >= 0.999
