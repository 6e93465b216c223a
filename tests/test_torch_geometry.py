"""The port's ``geometry.aabb`` and ``core.profiling`` against the JAX
package's (CPU). Each box function gets the same batch of boxes, points and
rays, made with numpy from a fixed seed; boolean and NaN results must be
equal, floats allclose to rtol 1e-6 (three-term sums may be added in
another order). The rays include axis-parallel ones, some with an origin on
a box plane, where a slab computes ``0 * inf = NaN``."""
import numpy as np
import pytest
import torch

from primitive3d_tpu.core import profiling as jprof
from primitive3d_tpu.geometry import aabb as jaabb
from primitive3d_tpu_torch.core import profiling as pprof
from primitive3d_tpu_torch.geometry import aabb as paabb

B = 64


def _boxes(rng, n=B):
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return np.stack([lo, lo + rng.uniform(0, 1.5, (n, 3)).astype(np.float32)],
                    axis=-2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    a, b = _boxes(rng), _boxes(rng)
    b[: B // 2, 0] -= 2.0  # some disjoint, some empty intersections
    p = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
    ro = rng.uniform(-3, 3, (B, 3)).astype(np.float32)
    rd = rng.standard_normal((B, 3)).astype(np.float32)
    # axis-parallel rays: one or two zero components, through the box or
    # past it, some with the origin on a box plane
    rd[:16, 1:] = 0.0
    rd[16:24, ::2] = 0.0
    ro[:4, 1] = a[:4, 0, 1]
    ro[4:8, 2] = a[4:8, 1, 2]
    ro[8:16, 1:] = (a[8:16, 0, 1:] + a[8:16, 1, 1:]) / 2
    tris = rng.uniform(-1.5, 2.5, (B, 3, 3)).astype(np.float32)
    return dict(a=a, b=b, p=p, ro=ro, rd=rd, tris=tris,
                pts=rng.standard_normal((B, 5, 3)).astype(np.float32))


CASES = {
    "from_points": lambda m, d: m.from_points(d["pts"]),
    "union": lambda m, d: m.union(d["a"], d["b"]),
    "diag": lambda m, d: m.diag(d["a"]),
    "inflate": lambda m, d: m.inflate(d["a"], 0.25),
    "intersection": lambda m, d: m.intersection(d["a"], d["b"]),
    "is_empty": lambda m, d: m.is_empty(m.intersection(d["a"], d["b"])),
    "intersects": lambda m, d: m.intersects(d["a"], d["b"]),
    "relative_pos": lambda m, d: m.relative_pos(d["a"], d["p"]),
    "center": lambda m, d: m.center(d["a"]),
    "contains": lambda m, d: m.contains(d["a"], d["p"]),
    "distance_sq": lambda m, d: m.distance_sq(d["a"], d["p"]),
    "signed_distance": lambda m, d: m.signed_distance(d["a"], d["p"]),
    "ray_intersect": lambda m, d: m.ray_intersect(d["a"], d["ro"], d["rd"]),
    "intersects_triangle": lambda m, d: m.intersects_triangle(d["a"],
                                                              d["tris"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_aabb_matches_jax(data, name):
    import jax.numpy as jnp

    want = np.asarray(CASES[name](jaabb, {k: jnp.asarray(v)
                                          for k, v in data.items()}))
    got = CASES[name](paabb, {k: torch.from_numpy(v)
                              for k, v in data.items()}).numpy()
    assert want.shape == got.shape and want.dtype == got.dtype
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "ray_intersect":
        # the axis-parallel rays: NaN where JAX gives NaN, and hits
        assert np.isnan(want[:16]).any()
        assert (want[:24, 0] < float(jaabb.MISS)).any()


def test_empty_box():
    e = paabb.empty_box((2,), device="cpu")
    np.testing.assert_array_equal(e.numpy(), np.asarray(jaabb.empty_box((2,))))
    assert paabb.MISS == float(jaabb.MISS)


def test_profiling_helpers(tmp_path, capsys):
    with pprof.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    calls = []

    def fn(salt):
        calls.append(salt)
        return (salt + 1.0) * 2.0

    s = pprof.amortized_seconds(fn, iters=3, device="cpu")
    assert s > 0 and len(calls) == 6  # a warm-up loop, then the timed one
    assert pprof.report_throughput("cast", 2_000_000, 0.5, "rays") == \
        jprof.report_throughput("cast", 2_000_000, 0.5, "rays")
    assert pprof.report_throughput("mc", 3_000, 0.5) == \
        jprof.report_throughput("mc", 3_000, 0.5)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "cast: 500.00 ms = 4.00 Mrays/s"
