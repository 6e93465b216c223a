"""Parity of the port's differentiable pipeline with the JAX package (CPU).

The same numpy grids, triangles and rays go through ``primitive3d_tpu`` and
``primitive3d_tpu_torch``. The JAX Pallas kernels run as the JAX package's
own tests run them off the TPU (``interpret=True``); the port runs the plain
versions of its kernels on CPU tensors. Covered: the triangle soup and its
backward, the plane scatter of the stream-tier backward, the differentiable
cluster cast at both tiers, the indexed mesh's backward, and the SDF-fitting
loss and its gradient at both backends. Tolerances are stated per test;
gradients differ from JAX only by the order of float32 sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu_torch as p3t
from primitive3d_tpu.kernels import raycast_kernel as jax_rk
from primitive3d_tpu.ops.marching_cubes import \
    marching_cubes_padded as jax_padded
from primitive3d_tpu.ops.marching_cubes import marching_cubes_soup as jax_soup
from primitive3d_tpu.pipeline import render_depth as jax_render
from primitive3d_tpu.pipeline import sdf_fitting_loss as jax_loss
from primitive3d_tpu.raycast import PallasRayCaster
from primitive3d_tpu_torch.bvh.clusters import build_mxu_clusters
from primitive3d_tpu_torch.core import debug
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.raycast import ClusterRayCaster
from primitive3d_tpu_torch.render.camera import camera_rays

from .test_torch_marching_cubes import BUNNY, sphere

BOX = dict(lower=(-1.0, -1.0, -1.0), upper=(1.0, 1.0, 1.0))


def fitting_grid(n=24):
    """The grid of examples/sdf_fitting.py: integer centre and radius, so
    some corners equal the threshold 0 exactly."""
    x, y, z = np.mgrid[:n, :n, :n].astype(np.float32)
    c, r = n / 2, n / 4
    return (-((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 - r ** 2)
            / n).astype(np.float32)


def sphere_density(n=16):
    """Off-centre sphere in index space (tests/test_pipeline.py): a centred
    one has exact mirror depth ties."""
    x, y, z = np.mgrid[:n, :n, :n].astype(np.float32)
    c, r = n / 2.0 + 0.37, n / 4.0
    return (-((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 - r ** 2)
            / n).astype(np.float32)


def front_rays(n=16, n_side=16):
    o = np.tile(np.array([n / 2, n / 2, -2.0 * n], np.float32),
                (n_side ** 2, 1))
    ys, xs = np.mgrid[0:n_side, 0:n_side]
    d = np.stack([(xs.ravel() + 0.5) / n_side - 0.5,
                  (ys.ravel() + 0.5) / n_side - 0.5,
                  np.full(n_side ** 2, 2.2, np.float32)], -1).astype(
                      np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


KW = dict(vert_capacity=1024, face_capacity=2048, max_dist=100.0, chunk=256)


@pytest.fixture
def both_tiers_at(monkeypatch):
    """Set the resident-tier cap of both packages' cluster casters."""
    def set_cap(cap):
        monkeypatch.setattr(PallasRayCaster, "MXU_MAX_TRIS", cap)
        monkeypatch.setattr(ClusterRayCaster, "MXU_MAX_TRIS", cap)
    return set_cap


def small_soup():
    """(T, 3, 3) triangles of the 24^3 off-centre sphere on [-1, 1]^3 and a
    1,024-ray camera looking at it."""
    res = p3t.marching_cubes_soup(sphere(), 0.0, face_capacity=2048,
                                  device="cpu", **BOX)
    cam = camera_rays(32, 32, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    return res.soup.numpy(), cam.origins, cam.dirs


# --- the triangle soup ------------------------------------------------------

@pytest.mark.parametrize("grid", ["bunny", "sphere"])
def test_soup_matches_jax(grid):
    """Soup to rtol/atol 1e-6 (XLA may fuse ``coords * scale + lower`` into
    an FMA), counts and flags exact; and the soup is the port's own indexed
    mesh ``vertices[faces]``, exactly."""
    g, kw, cap = ((np.load(BUNNY), {}, 32768) if grid == "bunny"
                  else (sphere(), BOX, 4096))
    want = jax_soup(jnp.asarray(g), 0.0, face_capacity=cap, **kw)
    got = p3t.marching_cubes_soup(g, 0.0, face_capacity=cap, device="cpu",
                                  **kw)
    assert isinstance(got, p3t.MCSoupResult)
    nf = int(got.num_faces)
    assert nf == int(want.num_faces) and 0 < nf <= cap
    assert bool(got.overflowed) == bool(want.overflowed) is False
    assert bool(got.active_overflow) == bool(want.active_overflow)
    np.testing.assert_allclose(got.soup.numpy(), np.asarray(want.soup),
                               rtol=1e-6, atol=1e-6)
    assert not got.soup[nf:].any()
    mesh = p3t.marching_cubes_padded(g, 0.0, vert_capacity=2 * cap,
                                     face_capacity=cap, device="cpu", **kw)
    assert torch.equal(mesh.vertices[mesh.faces.long()][:nf], got.soup[:nf])


@pytest.mark.parametrize("caps", [(1024, 0), (4096, 512)])
def test_soup_overflow_matches_jax(caps):
    """A too-small face budget, then a too-small active-cube budget: the
    counts and both flags equal the JAX package's."""
    fc, ac = caps
    want = jax_soup(jnp.asarray(sphere()), 0.0, face_capacity=fc,
                    active_capacity=ac, **BOX)
    got = p3t.marching_cubes_soup(sphere(), 0.0, face_capacity=fc,
                                  active_capacity=ac, device="cpu", **BOX)
    assert int(got.num_faces) == int(want.num_faces)
    assert bool(got.overflowed) and bool(want.overflowed)
    assert bool(got.active_overflow) == bool(want.active_overflow)
    assert bool(got.active_overflow) == (ac > 0)


def test_soup_overflow_names_the_budget():
    g = sphere()
    nf = int(p3t.marching_cubes_counts(g, 0.0, device="cpu")[1])
    with debug.checks(), pytest.raises(
            debug.CheckError, match=f"face_capacity 1024 .*{nf} faces"):
        p3t.marching_cubes_soup(g, 0.0, face_capacity=1024, device="cpu")
    with debug.checks(), pytest.raises(
            debug.CheckError, match=r"active_capacity 512 .*\d+ active cubes"):
        p3t.marching_cubes_soup(g, 0.0, face_capacity=4096,
                                active_capacity=512, device="cpu")
    with debug.checks():  # enough of both: no error
        p3t.marching_cubes_soup(g, 0.0, face_capacity=4096, device="cpu")


@pytest.mark.parametrize("grid", ["sphere", "fitting"])
def test_soup_backward_matches_jax(grid):
    """Gradient of <soup, random cotangent> with respect to the density
    against ``jax.vjp`` (rtol 1e-5, atol 1e-6: the scatter-adds into the
    grid sum in another order).

    The fitting grid has corners exactly at the threshold, where the
    interpolation ratio is exactly 0 or 1. JAX's ``clip`` gives half the
    gradient there, as ``torch.minimum(torch.maximum(x, 0), 1)`` does;
    ``torch.clamp`` passes all of it and fails this case.
    """
    g, kw = (sphere(), BOX) if grid == "sphere" else (fitting_grid(), {})
    if grid == "fitting":
        assert (g == 0.0).sum() > 0
    rng = np.random.default_rng(7)
    soup, vjp = jax.vjp(
        lambda d: jax_soup(d, 0.0, face_capacity=4096, **kw).soup,
        jnp.asarray(g))
    ct = rng.standard_normal(soup.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    dens = torch.from_numpy(g).requires_grad_()
    got = p3t.marching_cubes_soup(dens, 0.0, face_capacity=4096,
                                  device="cpu", **kw)
    got.soup.backward(torch.from_numpy(ct))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(dens.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_indexed_mesh_backward_matches_jax():
    """Autograd of the port's indexed mesh (``torch.clamp`` in its edge
    interpolation) equals the JAX package's hand-written VJP, which passes
    the full gradient where the ratio is exactly 0 or 1 (rtol 1e-5,
    atol 1e-6)."""
    g = fitting_grid()
    kw = dict(vert_capacity=2048, face_capacity=4096)
    rng = np.random.default_rng(3)
    verts, vjp = jax.vjp(lambda d: jax_padded(d, 0.0, **kw).vertices,
                         jnp.asarray(g))
    ct = rng.standard_normal(verts.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    dens = torch.from_numpy(g).requires_grad_()
    p3t.marching_cubes_padded(dens, 0.0, device="cpu", **kw).vertices \
        .backward(torch.from_numpy(ct))
    np.testing.assert_allclose(dens.grad.numpy(), want, rtol=1e-5, atol=1e-6)


# --- the plane scatter ------------------------------------------------------

def test_plane_scatter_plain_matches_jax():
    """The plain version against the JAX kernel (interpret mode) on a real
    stream list, real winners and random cotangents (rtol 1e-5, atol 1e-6:
    float64 sums against the TPU kernel's float32 ones). One ray's winner is
    moved to a cluster that is not flagged for its chunk; both add nothing
    for it."""
    tris, o, d = small_soup()
    cam = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    o, d = cam.origins, cam.dirs  # 4,096 rays: two blocks
    bvh = build_mxu_clusters(torch.from_numpy(tris), order="identity")
    C, S = bvh.num_clusters, bvh.cluster_size
    (_, sidx, _), (n, entries) = rk._cast_with_list(
        bvh, torch.from_numpy(o), torch.from_numpy(d), 10.0, True, True,
        False)
    widx = sidx.clone()
    assert widx.shape[0] % rk.MBLOCK == 0 and (widx >= 0).sum() > 100
    cm = rk._cluster_masks(n, entries, C)
    r = int(torch.nonzero(widx >= 0)[0])
    b, ch = r // rk.MBLOCK, (r % rk.MBLOCK) // rk.RCHUNK
    c_off = int(torch.nonzero(((cm[:, b] >> ch) & 1) == 0)[0])
    widx[r] = c_off * S + 3
    rng = np.random.default_rng(11)
    g = rng.standard_normal((widx.shape[0], 4)).astype(np.float32)
    want = jax_rk._plane_scatter_ws(
        jnp.asarray(g), jnp.asarray(widx.numpy()),
        jnp.asarray(n.numpy())[:, None, None],
        jnp.asarray(entries.numpy())[:, None], C, S, rk.NCH, rk.RCHUNK,
        interpret=True)
    before = rk.PLANE_SCATTER.launches
    got = rk.plane_scatter(torch.from_numpy(g), widx, n, entries, C, S)
    assert rk.PLANE_SCATTER.launches == before  # CPU: plain version only
    assert got.shape == (C * S, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    g[r] = 0.0
    assert torch.equal(got, rk.plane_scatter_plain(
        torch.from_numpy(g), widx, n, entries, C, S))


# --- the differentiable cast ------------------------------------------------

@pytest.mark.parametrize("tier", [32_000, 0])
def test_cast_clusters_diff_matches_jax(tier, monkeypatch):
    """Face ids equal, depth to rtol 1e-5 / atol 1e-6, and the gradient of
    <depth, random cotangent> with respect to the triangles against
    ``jax.vjp`` (rtol 1e-5, atol 2e-5 x its largest entry). Grazing hits
    magnify rounding: ``t = num / den`` with a small ``den``, and each
    vertex sums large plane cotangents times short edges. So in float32
    both packages land up to 3e-5 x the largest entry from a float64
    evaluation of the same hits, which the test also checks. At the stream
    tier the backward's work list is the forward's, which equals the list
    rebuilt from (boxes, o, d) as the JAX backward rebuilds it."""
    tris, o, d = small_soup()
    (depth_j, idx_j), vjp = jax.vjp(
        lambda t: jax_rk.cast_clusters_diff(t, jnp.asarray(o), jnp.asarray(d),
                                            interpret=True,
                                            mxu_max_tris=tier),
        jnp.asarray(tris), has_aux=False)
    ct = np.random.default_rng(5).standard_normal(o.shape[0]).astype(
        np.float32)
    want = np.asarray(vjp((jnp.asarray(ct), np.zeros(
        idx_j.shape, jax.dtypes.float0)))[0])

    lists = []
    scatter = rk.plane_scatter
    monkeypatch.setattr(rk, "plane_scatter", lambda g, w, n, e, C, S: (
        lists.append((n, e)), scatter(g, w, n, e, C, S))[1])
    t = torch.from_numpy(tris).requires_grad_()
    depth, idx = rk.cast_clusters_diff(t, torch.from_numpy(o),
                                       torch.from_numpy(d), mxu_max_tris=tier)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert 0.1 < float((idx >= 0).float().mean()) < 0.9
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(depth_j),
                               rtol=1e-5, atol=1e-6)
    depth.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5,
                               atol=2e-5 * np.abs(want).max())
    # float64: depth = (a - o).n / d.n at the same hits
    t64 = torch.from_numpy(tris).double().requires_grad_()
    a, b, c = t64.unbind(1)
    nrm = torch.linalg.cross(b - a, c - a, dim=-1)
    f = idx.clamp(min=0).long()
    o64, d64 = torch.from_numpy(o).double(), torch.from_numpy(d).double()
    dep64 = ((a[f] - o64) * nrm[f]).sum(-1) / (d64 * nrm[f]).sum(-1)
    (torch.where(idx >= 0, dep64, 0.0) * torch.from_numpy(ct)).sum().backward()
    for grad in (t.grad.numpy(), want):
        assert np.abs(grad - t64.grad.numpy()).max() <= 3e-5 * np.abs(
            want).max()
    assert len(lists) == (tier == 0)
    if lists:
        n, entries = lists[0]
        bvh = build_mxu_clusters(torch.from_numpy(tris), order="identity")
        pad = (-o.shape[0]) % rk.MBLOCK
        op = torch.cat([torch.from_numpy(o), torch.zeros((pad, 3))])
        dp = torch.cat([torch.from_numpy(d), torch.ones((pad, 3))])
        n2, e2, _ = rk._stream_entries(
            bvh.boxes, rk._ray_intervals(op, dp, op.shape[0] // rk.MBLOCK),
            10.0)
        assert torch.equal(n, n2) and torch.equal(entries, e2)


# --- the pipeline -----------------------------------------------------------

@pytest.mark.parametrize("case", ["pallas-resident", "pallas-stream", "mxu"])
def test_sdf_fitting_loss_matches_jax(case, both_tiers_at):
    """Loss (rtol 1e-6) and its gradient with respect to the density
    (rtol 1e-4, atol 1e-6 x its largest entry) against
    ``jax.value_and_grad``; the stream case sets both packages' resident
    caps to 0."""
    backend = case.split("-")[0]
    if case == "pallas-stream":
        both_tiers_at(0)
    g = sphere_density()
    o, d = front_rays()
    target = np.full((o.shape[0],), 24.0, np.float32)
    loss_j, grad_j = jax.value_and_grad(lambda x: jax_loss(
        x, jnp.asarray(o), jnp.asarray(d), jnp.asarray(target),
        backend=backend, **KW))(jnp.asarray(g))
    grad_j = np.asarray(grad_j)
    dens = torch.from_numpy(g).requires_grad_()
    loss = p3t.sdf_fitting_loss(dens, o, d, target, backend=backend,
                                device="cpu", **KW)
    loss.backward()
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-6)
    np.testing.assert_allclose(dens.grad.numpy(), grad_j, rtol=1e-4,
                               atol=1e-6 * np.abs(grad_j).max())


def test_render_depth_backends_agree():
    """The cluster path reproduces the all-pairs path, as in the JAX
    package's tests, and both equal JAX's hits."""
    g = sphere_density()
    o, d = front_rays()
    out_m = p3t.render_depth(g, o, d, backend="mxu", device="cpu", **KW)
    out_p = p3t.render_depth(g, o, d, backend="pallas", device="cpu", **KW)
    assert out_p.mc is None and out_m.mc is not None
    assert 0.1 < float(out_m.hit.float().mean()) < 0.9
    assert torch.equal(out_m.hit, out_p.hit)
    torch.testing.assert_close(out_m.depth, out_p.depth, rtol=1e-5,
                               atol=1e-5)
    want = jax_render(jnp.asarray(g), o, d, backend="pallas", **KW)
    np.testing.assert_array_equal(out_p.hit.numpy(), np.asarray(want.hit))
    assert torch.all(out_p.depth[~out_p.hit] == 100.0)


@pytest.mark.parametrize("backend", ["mxu", "pallas"])
def test_grad_matches_finite_differences(backend):
    """Directional derivative of a depth loss against central differences,
    as tests/test_pipeline.py does for the JAX package: the loss covers the
    rays that hit at the unperturbed density, and the direction avoids
    voxels near the zero crossing (so no topology change under +/- eps)."""
    dens = torch.from_numpy(sphere_density())
    o, d = front_rays()
    hit0 = p3t.render_depth(dens, o, d, backend=backend, device="cpu",
                            **KW).hit
    assert 8 < int(hit0.sum()) < 200

    def loss(g):
        out = p3t.render_depth(g, o, d, backend=backend, device="cpu", **KW)
        return torch.mean(torch.where(hit0, (out.depth - 37.0) ** 2, 0.0))

    x = dens.clone().requires_grad_()
    loss(x).backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0
    rng = np.random.RandomState(0)
    v = rng.standard_normal(dens.shape).astype(np.float32)
    v *= np.abs(dens.numpy()) > 0.1
    v = torch.from_numpy(v / np.linalg.norm(v))
    eps = 0.05
    with torch.no_grad():
        fd = (float(loss(dens + eps * v)) - float(loss(dens - eps * v))) / (
            2 * eps)
    ad = float((x.grad * v).sum())
    assert fd == pytest.approx(ad, rel=0.1, abs=1e-6)


def test_gradient_step_decreases_loss():
    """A few plain gradient steps of the fitting loop at toy size lower the
    loss (tests/test_pipeline.py's descent check)."""
    o, d = front_rays()
    target = p3t.render_depth(sphere_density(), o, d, device="cpu",
                              **KW).depth
    n = 16
    x, y, z = np.mgrid[:n, :n, :n].astype(np.float32)
    c = n / 2.0
    dens = torch.from_numpy(
        -((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 - (n / 2.5) ** 2) / n)
    losses = []
    for _ in range(6):
        dens.requires_grad_()
        loss = p3t.sdf_fitting_loss(dens, o, d, target, device="cpu", **KW)
        loss.backward()
        losses.append(float(loss))
        dens = (dens - 0.5 * dens.grad).detach()
    assert losses[-1] < losses[0]


def test_render_depth_limits_and_device(monkeypatch):
    """Past the stream tier's cluster cap the pallas path takes the
    scalar-broadcast tier (here with the cap lowered to 8 clusters of 128,
    so no 4M-face soup is needed) and renders what the stream tier renders;
    an unknown backend raises; every input goes to ``device``, the card by
    default, a tensor too; the gradient reaches a tensor input across the
    move (here a float64 leaf)."""
    g = sphere_density(8)
    o, d = front_rays(8, 4)
    calls = []
    cast_clusters = rk.cast_clusters

    def recording(*args, **kw):
        calls.append(args[0].tri_data.shape)
        return cast_clusters(*args, **kw)

    monkeypatch.setattr(rk, "cast_clusters", recording)
    kw = dict(vert_capacity=1024, face_capacity=2048, max_dist=100.0)
    g16, o16, d16 = sphere_density(), *front_rays()
    want = p3t.render_depth(g16, o16, d16, backend="pallas", device="cpu",
                            **kw)
    assert not calls
    monkeypatch.setattr(rk, "STREAM_MAX_CLUSTERS", 8)
    got = p3t.render_depth(g16, o16, d16, backend="pallas", device="cpu",
                           **kw)
    assert calls == [(2048 // 128, 128, 9)]
    assert torch.equal(got.hit, want.hit) and got.hit.any()
    torch.testing.assert_close(got.depth, want.depth, rtol=1e-6, atol=1e-6)
    depth, prim = rk.cast_clusters_diff(torch.zeros((4, 3, 3)),
                                        torch.zeros((2, 3)),
                                        torch.ones((2, 3)),
                                        mxu_stream_max_tris=3)
    assert len(calls) == 2 and prim.tolist() == [-1, -1]
    assert depth.tolist() == [10.0, 10.0]
    with pytest.raises(ValueError, match="backend"):
        p3t.render_depth(g, o, d, vert_capacity=64, face_capacity=64,
                         backend="optix", device="cpu")
    kw = dict(vert_capacity=256, face_capacity=512, max_dist=100.0)
    leaf = torch.from_numpy(g).double().requires_grad_()
    out = p3t.render_depth(leaf, o, d, device="cpu", **kw)
    assert out.depth.device.type == "cpu" and out.hit.any()
    out.depth.sum().backward()
    assert leaf.grad.dtype == torch.float64 and leaf.grad.abs().max() > 0
    if torch.cuda.is_available():
        return
    for density in (g, torch.from_numpy(g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p3t.sdf_fitting_loss(density, o, d,
                                 np.zeros(o.shape[0], np.float32), **kw)


@pytest.mark.parametrize("backend", ["mxu", "pallas"])
def test_render_depth_takes_jax_arguments(backend):
    """A call in the JAX package's form: ``vert_units`` / ``cube_units``
    are accepted and change nothing, and a 0-d tensor ``thresh`` gets the
    gradient of ``jax.grad(..., argnums=1)`` of the JAX loss (relative
    1e-5: sums in another order)."""
    g = sphere_density()
    o, d = front_rays()
    target = np.full(o.shape[0], 30.0, np.float32)
    kw = dict(KW, backend=backend)
    want = p3t.render_depth(g, o, d, device="cpu", **kw)
    got = p3t.render_depth(g, o, d, vert_units=7, cube_units=9,
                           device="cpu", **kw)
    assert torch.equal(want.depth, got.depth) and got.hit.any()
    t = torch.tensor(0.05, requires_grad=True)
    p3t.sdf_fitting_loss(g, o, d, target, thresh=t, vert_units=7,
                         cube_units=9, device="cpu", **kw).backward()
    gt = float(jax.grad(lambda th: jax_loss(
        jnp.asarray(g), o, d, target, thresh=th, vert_units=7,
        cube_units=9, **kw), argnums=0)(jnp.float32(0.05)))
    assert t.grad is not None and abs(gt) > 0
    np.testing.assert_allclose(float(t.grad), gt, rtol=1e-5)
