"""Parity of the PyTorch port's marching tetrahedra with the JAX package (CPU).

The same inputs, made with numpy from fixed seeds, go through
``primitive3d_tpu`` and ``primitive3d_tpu_torch``. Integers (faces,
``tet_idx``, counts) and the padded tails must be equal; positions agree to
rtol 1e-6 / atol 1e-6 (XLA may contract ``v_a * w_a + v_b * w_b`` into an
FMA where PyTorch rounds twice). Gradients of ``sum(vertices ** 2)`` agree
with ``jax.grad`` to rtol 1e-5 / atol 1e-6 in the sort tier; in the lattice
tier, whose SDF gradient sums terms of up to a few hundred that cancel,
atol is 1e-6 of the gradient's largest magnitude (a few float32 ulps of
those terms: the two packages add them in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu.ops import marching_tetrahedra as jmt
from primitive3d_tpu_torch.core import debug
from primitive3d_tpu_torch.ops import marching_tetrahedra as pmt

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data", "tetrahedra")
FIXTURE_CAPS = {"fit": (8192, 16384), "overflow": (100, 150)}
LATTICE_N, LATTICE_CAPS = 12, (2048, 4096)
# the compacted sort tier at the n = 12 lattice: roomy, and a face
# capacity below the 1,104 faces (A = 300 of its active tets)
COMPACT_CAPS = {"fit": (2048, 4096), "overflow": (2048, 300)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_same(want, got):
    """Two MTResults (or tuples of arrays) equal: integers exactly,
    positions allclose."""
    for name in ("faces", "tet_idx", "num_vertices", "num_faces"):
        w, g = _np(getattr(want, name)), _np(getattr(got, name))
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert got.faces.dtype == torch.int32
    np.testing.assert_allclose(_np(got.vertices), _np(want.vertices),
                               rtol=1e-6, atol=1e-6)


class Eager:
    """An eager (vertices, faces, tet_idx) triple as an MTResult-like."""

    def __init__(self, v, f, tid):
        self.vertices, self.faces, self.tet_idx = v, f, tid
        self.num_vertices = np.int32(v.shape[0])
        self.num_faces = np.int32(f.shape[0])


@pytest.fixture(scope="module")
def fixture():
    return (np.load(os.path.join(DATA, "points.npy")),
            np.load(os.path.join(DATA, "tetrahedras.npy")),
            np.load(os.path.join(DATA, "sdfs.npy")))


def lattice(n, deform=0.0, seed=3):
    pts, tets = jmt.grid_tetrahedra(n)
    if deform:
        rng = np.random.default_rng(seed)
        pts = pts + rng.standard_normal(pts.shape).astype(np.float32) * deform
    c = (n - 1) / 2.0
    sdf = ((n / 4.0) - np.linalg.norm(pts - c, axis=1)).astype(np.float32)
    return pts, tets, sdf


def random_mesh(trial):
    """The JAX tests' random meshes (tests/test_marching_tetrahedra.py)."""
    rng = np.random.default_rng(0)
    for _ in range(trial + 1):
        pts = rng.standard_normal((40, 3)).astype(np.float32)
        tets = rng.integers(0, 40, (60, 4))
        tets = tets[[len(set(t)) == 4 for t in tets]].astype(np.int64)
        sdf = rng.standard_normal(40).astype(np.float32)
    return pts, tets, sdf


def test_worked_example_and_tets_not_mutated():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    sdf = np.array([-1.0, -1.0, 0.5, 0.5], np.float32)
    # a tensor of the port's own index dtype, which no copy shields
    tets = torch.tensor([[1, 0, 2, 3]], dtype=torch.int64)
    v, f, tid = p3t.marching_tetrahedra(verts, tets, sdf, return_tet_idx=True,
                                        device="cpu")
    assert tets.tolist() == [[1, 0, 2, 3]]
    jv, jf, jtid = p3d.marching_tetrahedra(verts, tets.numpy(), sdf,
                                           return_tet_idx=True)
    assert_same(Eager(jv, jf, jtid), Eager(v, f, tid))
    # the reference's worked example, in its own corner order
    v, f, tid = p3t.marching_tetrahedra(verts, np.array([[0, 1, 2, 3]]), sdf,
                                        return_tet_idx=True, device="cpu")
    np.testing.assert_allclose(
        v.numpy(), [[0, 2 / 3, 0], [0, 0, 2 / 3], [1 / 3, 2 / 3, 0],
                    [1 / 3, 0, 2 / 3]], atol=1e-6)
    np.testing.assert_array_equal(f.numpy(), [[3, 0, 1], [3, 2, 0]])
    np.testing.assert_array_equal(tid.numpy(), [0, 0])


def test_fixture_eager(fixture):
    pts, tets, sdf = fixture
    want = Eager(*p3d.marching_tetrahedra(pts, tets, sdf,
                                          return_tet_idx=True))
    got = Eager(*p3t.marching_tetrahedra(pts, tets, sdf,
                                         return_tet_idx=True, device="cpu"))
    assert (int(got.num_vertices), int(got.num_faces)) == (4650, 9296)
    assert_same(want, got)
    v2, f2 = p3t.marching_tetrahedras(pts, tets, sdf, device="cpu")
    assert torch.equal(v2, got.vertices) and torch.equal(f2, got.faces)


@pytest.mark.parametrize("caps", sorted(FIXTURE_CAPS))
def test_fixture_padded(fixture, caps):
    """The whole padded arrays, tails included; "overflow" cuts both the
    vertices and the faces (4,650 / 9,296 into 100 / 150)."""
    pts, tets, sdf = fixture
    vc, fc = FIXTURE_CAPS[caps]
    want = p3d.marching_tetrahedra_padded(pts, tets, sdf, vert_capacity=vc,
                                          face_capacity=fc)
    got = p3t.marching_tetrahedra_padded(pts, tets, sdf, vert_capacity=vc,
                                         face_capacity=fc, device="cpu")
    assert_same(want, got)
    assert bool(got.overflowed) == (caps == "overflow")
    nv, nf = min(int(got.num_vertices), vc), min(int(got.num_faces), fc)
    assert (got.vertices[nv:] == 0).all() and (got.faces[nf:] == 0).all()
    assert (got.tet_idx[nf:] == -1).all()


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_random_meshes(trial):
    pts, tets, sdf = random_mesh(trial)
    want = Eager(*p3d.marching_tetrahedra(pts, tets, sdf,
                                          return_tet_idx=True))
    got = Eager(*p3t.marching_tetrahedra(pts, tets, sdf,
                                         return_tet_idx=True, device="cpu"))
    assert int(got.num_faces) > 0
    assert_same(want, got)


def test_no_surface():
    verts = np.eye(4, 3, dtype=np.float32) * 2
    v, f = p3t.marching_tetrahedra(verts, np.array([[0, 1, 2, 3]]),
                                   np.ones(4, np.float32), device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_tie_order_does_not_reach_the_output(fixture, monkeypatch):
    """Equal (min, max) pairs share their head's vertex id, so a sort that
    puts them in any other order gives the same result: here ties come out
    in descending slot order instead of the stable ascending one."""
    pts, tets, sdf = fixture
    args = (torch.from_numpy(pts), torch.from_numpy(tets),
            torch.from_numpy(sdf), 8192, 16384, False)
    want = pmt._mt_sort_impl(*args)

    class ReversedTies:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def sort(key, stable):
            slot = torch.arange(key.numel())
            order = torch.argsort(key * key.numel() + (key.numel() - 1 - slot),
                                  stable=True)
            assert not torch.equal(order, torch.sort(key, stable=True)[1])
            return key[order], order

    monkeypatch.setattr(pmt, "torch", ReversedTies())
    assert_same(want, pmt._mt_sort_impl(*args))


def test_compaction_rule(monkeypatch):
    """The sort tier compacts past _DENSE_MAX_TETS tets, as the JAX
    package's T-major tier takes over there."""
    assert pmt._DENSE_MAX_TETS == jmt._DENSE_MAX_TETS
    seen = []
    impl = pmt._mt_sort_impl
    monkeypatch.setattr(pmt, "_mt_sort_impl",
                        lambda *a: seen.append(a[-1]) or impl(*a))
    pts, tets, sdf = lattice(4)
    for limit in (len(tets), len(tets) - 1):
        monkeypatch.setattr(pmt, "_DENSE_MAX_TETS", limit)
        p3t.marching_tetrahedra_padded(pts, tets, sdf, vert_capacity=64,
                                       face_capacity=64, device="cpu")
    assert seen == [False, True]


@pytest.fixture(scope="module")
def jax_tmajor():
    return jax.jit(jmt._mt_impl_tmajor, static_argnums=(3, 4))


@pytest.mark.parametrize("caps", sorted(COMPACT_CAPS))
def test_compacted_form(jax_tmajor, caps):
    """The sort tier's compaction to A = min(face_capacity, T) active tets,
    forced at a small T, against the JAX T-major tier; on a face overflow
    both number only the crossing edges of the first A active tets."""
    pts, tets, sdf = lattice(LATTICE_N)
    vc, fc = COMPACT_CAPS[caps]
    want = jax_tmajor(jnp.asarray(pts), jnp.asarray(tets), jnp.asarray(sdf),
                      vc, fc)
    got = pmt._mt_sort_impl(torch.from_numpy(pts),
                            torch.from_numpy(tets).long(),
                            torch.from_numpy(sdf), vc, fc, True)
    assert_same(want, got)
    if caps == "overflow":
        assert int(got.num_faces) > fc
        assert int(got.num_vertices) < 554  # all tets: 554 vertices


@pytest.mark.parametrize("deform", [0.0, 0.15, 0.8, None])
def test_lattice_tier(deform):
    """The lattice tier against the JAX one (``None``: the index-space
    lattice without positions), and against the port's own sort tier on
    ``grid_tetrahedra(n)``: deform 0.8 inverts some cells."""
    n = LATTICE_N
    pts, tets, sdf = lattice(n, deform or 0.0)
    vin = None if deform is None else pts
    vc, fc = LATTICE_CAPS
    want = p3d.marching_tetrahedra_lattice(vin, sdf, n, vert_capacity=vc,
                                           face_capacity=fc)
    got = p3t.marching_tetrahedra_lattice(vin, sdf, n, vert_capacity=vc,
                                          face_capacity=fc, device="cpu")
    assert int(got.num_vertices) > 100
    assert_same(want, got)
    sort = p3t.marching_tetrahedra_padded(pts, tets, sdf, vert_capacity=vc,
                                          face_capacity=fc, device="cpu")
    assert_same(sort, got)


def _grads(fn_j, fn_p, pts, sdf):
    def loss(p, s):
        return jnp.sum(fn_j(p, s).vertices ** 2)

    jp, js = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pts),
                                            jnp.asarray(sdf))
    p = torch.from_numpy(pts).requires_grad_()
    s = torch.from_numpy(sdf).requires_grad_()
    (fn_p(p, s).vertices ** 2).sum().backward()
    return (np.asarray(jp), np.asarray(js)), (p.grad.numpy(), s.grad.numpy())


def test_sort_tier_gradients(fixture):
    pts, tets, sdf = fixture
    vc, fc = FIXTURE_CAPS["fit"]
    tj = jnp.asarray(tets, jnp.int32)
    want, got = _grads(
        lambda p, s: p3d.marching_tetrahedra_padded(
            p, tj, s, vert_capacity=vc, face_capacity=fc),
        lambda p, s: p3t.marching_tetrahedra_padded(
            p, tets, s, vert_capacity=vc, face_capacity=fc, device="cpu"),
        pts, sdf)
    for w, g in zip(want, got):
        assert np.abs(w).sum() > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_lattice_gradients():
    n = 10
    pts, _, sdf = lattice(n, 0.1)
    want, got = _grads(
        lambda p, s: p3d.marching_tetrahedra_lattice(
            p, s, n, vert_capacity=1024, face_capacity=2048),
        lambda p, s: p3t.marching_tetrahedra_lattice(
            p, s, n, vert_capacity=1024, face_capacity=2048, device="cpu"),
        pts, sdf)
    for w, g in zip(want, got):
        assert np.abs(w).sum() > 0
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


def test_grid_tetrahedra():
    for a, b in zip(jmt.grid_tetrahedra(5), p3t.grid_tetrahedra(5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tables_and_exports():
    for name in ("TET_EDGES", "MT_TRI_TABLE", "MT_NUM_TRIS"):
        a, b = getattr(jmt, name), getattr(pmt, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(p3d.__all__) <= set(p3t.__all__)
    for name in p3t.__all__:
        assert hasattr(p3t, name), name
    assert p3t.marching_tetrahedras is p3t.marching_tetrahedra
    assert p3t.MTResult is pmt.MTResult


def test_errors_and_checks():
    v = np.zeros((4, 3), np.float32)
    t = np.array([[0, 1, 2, 3]])
    s = np.ones(4, np.float32)
    kw = dict(vert_capacity=8, face_capacity=8, device="cpu")
    with pytest.raises(ValueError, match=r"vertices must be \(N, 3\)"):
        p3t.marching_tetrahedra_padded(v[:, :2], t, s, **kw)
    with pytest.raises(ValueError, match=r"tets must be \(T, 4\)"):
        p3t.marching_tetrahedra_padded(v, t[:, :3], s, **kw)
    with pytest.raises(ValueError, match=r"sdf must be \(N,\)"):
        p3t.marching_tetrahedra_padded(v, t, s[:3], **kw)
    with pytest.raises(ValueError, match=r"vertices must be \(8, 3\)"):
        p3t.marching_tetrahedra_lattice(v, np.ones(8, np.float32), 2, **kw)
    with pytest.raises(ValueError, match=r"sdf must be \(8,\)"):
        p3t.marching_tetrahedra_lattice(None, s, 2, **kw)
    with debug.checks():
        with pytest.raises(debug.CheckError, match="index out of range"):
            p3t.marching_tetrahedra_padded(v, t + 4, s, **kw)
        bad = s.copy()
        bad[1] = np.nan
        with pytest.raises(debug.CheckError, match="sdf contains non-finite"):
            p3t.marching_tetrahedra_padded(v, t, bad, **kw)
        with pytest.raises(debug.CheckError, match="sdf contains non-finite"):
            p3t.marching_tetrahedra_lattice(None, np.full(8, np.inf,
                                                          np.float32), 2, **kw)
