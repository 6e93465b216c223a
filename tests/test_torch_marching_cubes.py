"""Parity of the PyTorch port's marching cubes with the JAX package (CPU).

The same grids, made with numpy, go through ``primitive3d_tpu`` and
``primitive3d_tpu_torch``. The JAX mask kernel runs as its own tests run it
on the CPU (``fused_masks(..., interpret=True)``); the port runs its plain
versions on CPU tensors. Integers (masks, counts, faces, padded tails) must
match exactly; vertices within 1e-5 of the bounding-box size, since XLA may
fuse ``coords * scale + lower`` into an FMA where PyTorch rounds twice.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.kernels.mc_masks import fused_masks as jax_fused_masks
from primitive3d_tpu.ops import mc_tables as jax_tables
from primitive3d_tpu_torch.kernels import mc_masks as port_masks
from primitive3d_tpu_torch.ops import mc_tables as port_tables
from tests.mask_cases import special_grid

BUNNY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data", "bunny.npy")


def sphere(n=24, c=(0.13, -0.07, 0.05), r=0.6):
    """Off-centre sphere SDF on [-1, 1]^3 (positive inside)."""
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(r) - np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2
                                    + (z - c[2]) ** 2)).astype(np.float32)


GRIDS = {"bunny": lambda: np.load(BUNNY), "sphere24": sphere}
SCALES = {"none": None, "float": 1.5, "bbox": ((-1.0, -2.0, 0.5),
                                               (1.0, 2.0, 3.5))}


def _bbox_size(shape, scale):
    from primitive3d_tpu_torch.core.grid import resolve_bounds
    lo, up = resolve_bounds(shape, scale)
    return float(np.max(up - lo))


@pytest.mark.parametrize("name", ["TRI_TABLE", "NUM_TRIS", "PACKED_TRI",
                                  "EDGE_AXIS", "EDGE_OFFSET", "EDGE_CORNERS",
                                  "CORNER_OFFSETS"])
def test_tables_equal_jax(name):
    a, b = getattr(jax_tables, name), getattr(port_tables, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert port_tables.MAX_TRIS_PER_CUBE == jax_tables.MAX_TRIS_PER_CUBE


@pytest.mark.parametrize("shape,thresh", [((20, 23, 29), 0.1),
                                          ((7, 5, 9), -0.3),
                                          ((2, 2, 2), 0.0),
                                          ((2, 3, 66), 0.1),
                                          ((5, 2, 3), 0.0),
                                          ((3, 7, 17), -0.3)])
def test_masks_match_jax_kernel(shape, thresh):
    """The shapes the card kernel's tiling finds hard (X, Y or Z of 2;
    rows of Z - 1 bytes that are not a multiple of 4), with values at the
    threshold, +-inf and NaN."""
    grid = special_grid(shape, thresh, sum(shape))
    want = jax_fused_masks(jnp.asarray(grid), jnp.float32(thresh),
                           interpret=True)
    before = port_masks.KERNEL.launches
    got = port_masks.fused_masks(torch.from_numpy(grid), thresh)
    assert port_masks.KERNEL.launches == before  # CPU: plain version only
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[
            w.dtype.type]
        np.testing.assert_array_equal(w, g.numpy())


@pytest.mark.parametrize("scale", list(SCALES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_marching_cubes_matches_jax(grid, scale):
    g, sc = GRIDS[grid](), SCALES[scale]
    vj, fj = p3d.marching_cubes(g, 0.0, scale=sc)
    vj, fj = np.asarray(vj), np.asarray(fj)
    vt, ft = p3t.marching_cubes(g, 0.0, scale=sc, device="cpu")
    vc, fc = p3t.marching_cubes(g, 0.0, scale=sc, cpu=True)
    assert ft.dtype == torch.int32 and vt.dtype == torch.float32
    np.testing.assert_array_equal(fj, ft.numpy())
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0,
                               atol=1e-5 * _bbox_size(g.shape, sc))
    assert torch.equal(ft, fc) and torch.equal(vt, vc)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_counts_match_jax(grid):
    g = GRIDS[grid]()
    nv, nf = p3d.marching_cubes_counts(g, 0.0)
    tv, tf = p3t.marching_cubes_counts(g, 0.0, device="cpu")
    assert (int(nv), int(nf)) == (int(tv), int(tf))


@pytest.mark.parametrize("active", [0, 1024])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_padded_matches_jax(grid, active):
    g = GRIDS[grid]()
    kw = dict(vert_capacity=16384, face_capacity=32768,
              lower=(-1.0, -1.0, -1.0), upper=(1.0, 1.0, 1.0),
              active_capacity=active)
    want = p3d.marching_cubes_padded(g, 0.0, **kw)
    got = p3t.marching_cubes_padded(g, 0.0, device="cpu", **kw)
    assert int(want.num_vertices) == int(got.num_vertices)
    assert int(want.num_faces) == int(got.num_faces)
    assert bool(want.overflowed) == bool(got.overflowed)
    if bool(got.overflowed):  # the active budget ran out: flags only
        assert active and bool(got.unit_overflow)
        return
    np.testing.assert_array_equal(np.asarray(want.faces), got.faces.numpy())
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(want.vertices), rtol=0, atol=2e-5)
    nv, nf = int(got.num_vertices), int(got.num_faces)
    assert not got.vertices[nv:].any() and not got.faces[nf:].any()


@pytest.mark.parametrize("caps", [(64, 4096), (4096, 64), (64, 64)])
def test_overflow_matches_jax(caps):
    g = sphere()
    kw = dict(vert_capacity=caps[0], face_capacity=caps[1])
    want = p3d.marching_cubes_padded(g, 0.0, **kw)
    got = p3t.marching_cubes_padded(g, 0.0, device="cpu", **kw)
    assert bool(want.overflowed) and bool(got.overflowed)
    assert int(want.num_vertices) == int(got.num_vertices)
    assert int(want.num_faces) == int(got.num_faces)
    assert bool(want.unit_overflow) == bool(got.unit_overflow)


def test_padded_config_and_checks():
    from primitive3d_tpu_torch.core import debug
    cfg = p3t.MarchingCubesConfig(vert_capacity=4096, face_capacity=8192)
    g = sphere()
    res = p3t.marching_cubes_padded(g, 0.0, config=cfg, device="cpu")
    assert res.vertices.shape == (4096, 3) and res.faces.shape == (8192, 3)
    with pytest.raises(ValueError):
        p3t.marching_cubes_padded(g, 0.0, device="cpu")
    with debug.checks(), pytest.raises(debug.CheckError, match="overflow"):
        p3t.marching_cubes_padded(g, 0.0, vert_capacity=8, face_capacity=8,
                                  device="cpu")


def test_empty_grid():
    v, f = p3t.marching_cubes(np.ones((5, 6, 7), np.float32), 0.0,
                              device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_entry_points_default_to_the_card():
    g = sphere(8)
    calls = [
        lambda: p3t.marching_cubes(g, 0.0),
        lambda: p3t.marching_cubes_padded(g, 0.0, vert_capacity=64,
                                          face_capacity=64),
        lambda: p3t.marching_cubes_counts(g, 0.0),
        lambda: p3t.create_raycaster(np.zeros((3, 3), np.float32),
                                     np.array([[0, 1, 2]])),
    ]
    if torch.cuda.is_available():
        assert p3t.marching_cubes(g, 0.0)[0].device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- thresh as a tensor, the JAX package's unit budgets, count dtypes ------

def _thresh_grad_jax(form, g, t0, ct):
    """d<out, ct>/d thresh of the JAX function at ``t0`` (jax.grad,
    argnums=1); the eager form is the padded one cut to the eager counts."""
    import jax
    from primitive3d_tpu.ops.marching_cubes import \
        marching_cubes_padded as jax_padded
    from primitive3d_tpu.ops.marching_cubes import \
        marching_cubes_soup as jax_soup
    box = dict(lower=(-1.0, -1.0, -1.0), upper=(1.0, 1.0, 1.0))

    def out(d, t):
        if form == "soup":
            return jax_soup(d, t, face_capacity=4096, **box).soup
        v = jax_padded(d, t, vert_capacity=2048, face_capacity=4096,
                       **box).vertices
        return v[:ct.shape[0]] if form == "eager" else v

    return float(jax.grad(lambda d, t: jnp.sum(out(d, t) * ct),
                          argnums=1)(jnp.asarray(g), jnp.float32(t0)))


@pytest.mark.parametrize("form", ["padded", "eager", "soup"])
def test_thresh_gradient_matches_jax(form):
    """A 0-d tensor ``thresh`` gets the gradient of the JAX package's
    functions (its hand-written VJP's ``dthresh`` for the indexed mesh,
    autodiff of ``dt`` for the soup), relative tolerance 1e-5: the sum
    over vertices runs in another order. The mask pass reads its value."""
    g, t0 = sphere(16), 0.1
    rng = np.random.default_rng(11)
    box = dict(lower=(-1.0, -1.0, -1.0), upper=(1.0, 1.0, 1.0))
    t = torch.tensor(t0, requires_grad=True)
    if form == "padded":
        out = p3t.marching_cubes_padded(g, t, vert_capacity=2048,
                                        face_capacity=4096, device="cpu",
                                        **box).vertices
    elif form == "soup":
        out = p3t.marching_cubes_soup(g, t, face_capacity=4096,
                                      device="cpu", **box).soup
    else:
        out = p3t.marching_cubes(g, t, scale=(-1.0, 1.0), device="cpu")[0]
        want_v, _ = p3t.marching_cubes(g, t0, scale=(-1.0, 1.0),
                                       device="cpu")
        assert torch.equal(out.detach(), want_v)
    ct = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(ct)).sum().backward()
    want = _thresh_grad_jax(form, g, t0, ct)
    assert t.grad is not None and abs(want) > 0
    np.testing.assert_allclose(float(t.grad), want, rtol=1e-5)


def test_vert_and_cube_units_are_accepted():
    """The JAX package's ``vert_units`` / ``cube_units`` are accepted and
    change nothing, as arguments and as config fields."""
    g = sphere(16)
    kw = dict(vert_capacity=2048, face_capacity=4096, device="cpu")
    want = p3t.marching_cubes_padded(g, 0.0, **kw)
    got = p3t.marching_cubes_padded(g, 0.0, vert_units=64, cube_units=32,
                                    **kw)
    cfg = p3t.MarchingCubesConfig(vert_capacity=2048, face_capacity=4096,
                                  vert_units=64, cube_units=32)
    by_cfg = p3t.marching_cubes_padded(g, 0.0, config=cfg, device="cpu")
    for res in (got, by_cfg):
        for a, b in zip(want, res):
            assert torch.equal(a, b)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_count_dtypes_match_jax(grid):
    """Returned counts are int32, as the JAX package's, and equal them."""
    g = GRIDS[grid]()
    kw = dict(vert_capacity=16384, face_capacity=32768)
    want = p3d.marching_cubes_padded(g, 0.0, **kw)
    got = p3t.marching_cubes_padded(g, 0.0, device="cpu", **kw)
    soup_j = p3d.marching_cubes_soup(g, 0.0, face_capacity=32768)
    soup_t = p3t.marching_cubes_soup(g, 0.0, face_capacity=32768,
                                     device="cpu")
    pairs = list(zip(p3d.marching_cubes_counts(g, 0.0),
                     p3t.marching_cubes_counts(g, 0.0, device="cpu")))
    pairs += [(want.num_vertices, got.num_vertices),
              (want.num_faces, got.num_faces),
              (soup_j.num_faces, soup_t.num_faces)]
    for w, t in pairs:
        assert np.asarray(w).dtype == np.int32 and t.dtype == torch.int32
        assert t.shape == () and int(t) == int(w)
    assert soup_t.num_active.dtype == torch.int32
