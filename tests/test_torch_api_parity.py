"""The port's public surface against the JAX package's, module by module.

For every module of ``primitive3d_tpu`` (``pkgutil.walk_packages``) and the
module of the same dotted name in ``primitive3d_tpu_torch``, one case
asserts:

  * every public name of the JAX module is in the port's. A name is public
    when it is in ``__all__`` or, with no ``__all__``, when it does not
    start with ``_`` and is a class or function of the package (its own or
    re-exported) or a constant. The port may add names of its own: its
    kernels' wrappers and plain versions, and the helpers they share;
  * NamedTuple ``_fields`` and ``_field_defaults``, and dataclass fields
    and defaults, are equal;
  * functions and methods take the same parameters, in the same order, of
    the same kinds and with the same defaults. The port may add ``device``,
    and may lack the TPU-only ``interpret``, ``rchunk`` and ``precision``;
  * each class has the public attributes and methods of its JAX class.

Every other difference is a fault of the port, unless ``DELIBERATE`` holds
it with its reason; an entry there that no longer differs fails too. The
sweep only imports and inspects. Then behaviour tests of the names the
sweep guards, on 16^3 grids on the CPU.
"""
import dataclasses
import importlib
import inspect
import numbers
import pkgutil
import types
from typing import NamedTuple

import numpy as np
import pytest
import torch

import primitive3d_tpu as p3d
import primitive3d_tpu_torch as p3t
from primitive3d_tpu_torch.core import debug, timer
from primitive3d_tpu_torch.core.config import RayCastConfig
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.ops.marching_cubes import MCResult, MCSoupResult
from primitive3d_tpu_torch.raycast import ClusterRayCaster, PallasRayCaster
from primitive3d_tpu_torch.render.camera import camera_rays

# parameters the port drops: TPU tiling and matmul-precision knobs
TPU_ONLY = frozenset({"interpret", "rchunk", "precision"})

# each difference the sweep finds that is meant: {path: (what the sweep
# reports there, why)}; a "+" path is a module of the port alone
DELIBERATE = {
    "+core.device": ("module", "device resolution for the device= argument "
                               "every entry point takes"),
    "+kernels._build": ("module", "nvcc builds of csrc/ and the kernels' "
                                  "launch counts"),
    "bvh.clusters.MxuClusterBVH": ("fields, no w2",
                                   "fp32 rows w and a sub-box level where JAX "
                                   "has double-bf16 w2 (CHANGES.md §8)"),
    "core.profiling.trace": ("signature", "log_dir=None resolves to the temp "
                                          "directory, not a fixed /tmp path"),
    "kernels.mc_masks.XB": ("missing", "rows of the TPU kernel's block; the "
                                       "CUDA kernel tiles whole z-rows"),
    "kernels.raycast_kernel.cast_clusters": (
        "signature", "takes the scalar tier's box tree (tree=), built once "
                     "by the caster"),
    "parallel.marching_cubes.mc_shard_body": (
        "signature", "takes the process-group mesh where JAX takes "
                     "axis_name"),
    "parallel.marching_tetrahedra.mt_lattice_shard_body": (
        "signature", "takes the process-group mesh where JAX takes "
                     "axis_name"),
    "parallel.mesh.sharded_along": (
        "signature", "slices x for this rank (mesh, x) where JAX returns a "
                     "sharding (mesh, axis_name)"),
    "parallel.mesh.replicated": (
        "signature", "returns x on this rank (mesh, x) where JAX returns a "
                     "sharding (mesh)"),
    "parallel.mesh.initialize_distributed": (
        "signature", "torch.distributed needs an init_method and a backend"),
    "core.debug.checked": ("signature", "no errors=: it names checkify error "
                                        "sets, which have no counterpart"),
}


def _modules(pkg):
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(
            info.name)
    return out


JAX_MODULES = _modules(p3d)
PORT_MODULES = _modules(p3t)


def _is_constant(obj):
    return (isinstance(obj, (numbers.Number, str, bytes, tuple, frozenset,
                             np.ndarray, np.generic, torch.Tensor))
            or type(obj).__name__ == "ArrayImpl")  # a jax.Array constant


def public_names(mod, root):
    """The public names of ``mod``, a module of the package ``root``."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if isinstance(obj, type) or inspect.isroutine(obj):
            if (getattr(obj, "__module__", None) or "").split(".")[0] == root:
                out.add(name)
        elif _is_constant(obj):
            out.add(name)
    return out


def _params(fn, other, port):
    """(name, kind, default) of ``fn``'s parameters, normalised against the
    parameter names ``other`` of its counterpart."""
    out = []
    for p in inspect.signature(fn).parameters.values():
        if port and p.name == "device" and "device" not in other:
            continue
        if not port and p.name in TPU_ONLY and p.name not in other:
            continue
        out.append((p.name, p.kind, p.default))
    return out


def _same(a, b):
    try:
        return bool(a == b)
    except Exception:  # arrays and other values without a plain ==
        return repr(a) == repr(b)


def _same_items(a, b):
    return len(a) == len(b) and all(
        x[:-1] == y[:-1] and _same(x[-1], y[-1]) for x, y in zip(a, b))


def _signature_differs(fj, fp):
    try:
        sj, sp = inspect.signature(fj), inspect.signature(fp)
    except (TypeError, ValueError):  # builtins without a signature
        return False
    return not _same_items(_params(fj, set(sp.parameters), False),
                           _params(fp, set(sj.parameters), True))


def _class_differs(cj, cp):
    """What differs between the JAX class ``cj`` and the port's ``cp``."""
    out = []
    if hasattr(cj, "_fields") and (
            cj._fields != getattr(cp, "_fields", None)
            or not _same_items(sorted(cj._field_defaults.items()), sorted(
                getattr(cp, "_field_defaults", {}).items()))):
        out.append("fields")
    if dataclasses.is_dataclass(cj):
        fj = [(f.name, f.default) for f in dataclasses.fields(cj)]
        fp = ([(f.name, f.default) for f in dataclasses.fields(cp)]
              if dataclasses.is_dataclass(cp) else [])
        if not _same_items(fj, fp):
            out.append("fields")
    generated = hasattr(cj, "_fields") or dataclasses.is_dataclass(cj)
    for name in dir(cj):
        if name.startswith("_") and name != "__init__":
            continue
        if not hasattr(cp, name):
            out.append(f"no {name}")
            continue
        aj = inspect.getattr_static(cj, name)
        ap = inspect.getattr_static(cp, name)
        if name == "__init__" and (generated or aj is object.__init__):
            continue
        if (inspect.isfunction(aj) and inspect.isfunction(ap)
                and _signature_differs(aj, ap)):
            out.append(f"{name} signature")
    return out


def differences(jmod, pmod, where, jroot):
    """{path: what} of the port module ``pmod`` against the JAX module
    ``jmod``; ``where`` is their dotted name, ``jroot`` the JAX package's."""
    out = {}
    for name in sorted(public_names(jmod, jroot)):
        path = f"{where}.{name}" if where else name
        if not hasattr(pmod, name):
            out[path] = "missing"
            continue
        oj, op = getattr(jmod, name), getattr(pmod, name)
        if isinstance(oj, type):
            what = _class_differs(oj, op) if isinstance(op, type) else [
                "not a class"]
            if what:
                out[path] = ", ".join(what)
        elif inspect.isroutine(oj) and _signature_differs(oj, op):
            out[path] = "signature"
    return out


@pytest.mark.parametrize("where", sorted(JAX_MODULES))
def test_module_matches_the_jax_module(where):
    assert where in PORT_MODULES, f"the port has no module {where!r}"
    found = differences(JAX_MODULES[where], PORT_MODULES[where], where,
                        "primitive3d_tpu")
    faults = {p: w for p, w in found.items()
              if DELIBERATE.get(p, (None,))[0] != w}
    assert not faults, f"the port differs from the JAX package: {faults}"
    # an allowed difference of this module that is gone leaves the list
    mine = {p for p in DELIBERATE if not p.startswith("+")
            and p.rpartition(".")[0] == where}
    assert mine <= set(found), f"no longer differs: {mine - set(found)}"


def test_the_port_adds_only_its_own_modules():
    extra = {f"+{m}" for m in set(PORT_MODULES) - set(JAX_MODULES)}
    assert extra == {p for p in DELIBERATE if p.startswith("+")}
    assert all(what and why for what, why in DELIBERATE.values())


def _fake_pair(fault):
    """A made-up (JAX, port) pair of modules that differ only by ``fault``,
    their classes and functions defined in this test's package."""
    root = __name__.split(".")[0]

    class Hit(NamedTuple):
        depth: float
        face: int = -1

    class PortHit(NamedTuple):
        depth: float
        face: int = 0 if fault == "field default" else -1

    def cast(rays, max_dist=10.0, interpret=False):
        return rays

    def port_cast(rays, max_dist=20.0 if fault == "parameter default"
                  else 10.0, device="cuda"):
        return rays

    jmod, pmod = types.ModuleType(f"{root}.fake"), types.ModuleType(
        f"{root}.fake_port")
    for obj in (Hit, PortHit, cast, port_cast):
        obj.__module__ = f"{root}.fake"
    jmod.Hit, jmod.cast, jmod.MISS = Hit, cast, 3.0e38
    pmod.Hit, pmod.cast = PortHit, port_cast
    if fault != "missing name":
        pmod.MISS = 3.0e38
    return jmod, pmod, root


@pytest.mark.parametrize("fault,path", [("field default", "fake.Hit"),
                                        ("parameter default", "fake.cast"),
                                        ("missing name", "fake.MISS")])
def test_the_sweep_reports_an_injected_difference(fault, path):
    jmod, pmod, root = _fake_pair(fault)
    assert differences(jmod, pmod, "fake", root) == {
        path: {"field default": "fields", "parameter default": "signature",
               "missing name": "missing"}[fault]}
    # the same pair without the fault: no difference at all
    jmod, pmod, root = _fake_pair(None)
    assert differences(jmod, pmod, "fake", root) == {}


# --- the repaired names, in use ---------------------------------------------

def sphere16():
    ax = np.linspace(-1.0, 1.0, 16).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(0.6) - np.sqrt((x - 0.13) ** 2 + (y + 0.07) ** 2
                                      + (z - 0.05) ** 2)).astype(np.float32)


def test_soup_result_unpacks_as_in_jax():
    g = sphere16()
    soup, n, ovf = p3t.marching_cubes_soup(g, 0.0, face_capacity=2048,
                                           device="cpu")
    j_soup, j_n, j_ovf = p3d.marching_cubes_soup(g, 0.0, face_capacity=2048)
    assert soup.shape == j_soup.shape == (2048, 3, 3)
    assert int(n) == int(j_n) > 0 and bool(ovf) == bool(j_ovf) is False
    # the default active_overflow of both packages' types
    res = MCSoupResult(soup, n)
    assert res.active_overflow is False and not bool(res.overflowed)
    assert bool(MCSoupResult(soup[:8], n).overflowed)


def test_mc_result_constructs_without_unit_overflow():
    g = sphere16()
    r = p3t.marching_cubes_padded(g, 0.0, vert_capacity=2048,
                                  face_capacity=4096, device="cpu")
    res = MCResult(r.vertices, r.faces, r.num_vertices, r.num_faces)
    assert res.unit_overflow is False and not bool(res.overflowed)
    assert bool(MCResult(r.vertices, r.faces[:8], r.num_vertices,
                         r.num_faces).overflowed)
    assert bool(res._replace(unit_overflow=torch.tensor(True)).overflowed)


def test_pallas_ray_caster_is_the_cluster_caster():
    v, f = p3t.marching_cubes(sphere16(), 0.0, scale=(-1.0, 1.0),
                              device="cpu")
    cam = camera_rays(32, 32, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    assert PallasRayCaster is ClusterRayCaster
    assert PallasRayCaster.MXU_STREAM_MAX_TRIS == 2_000_000
    got = PallasRayCaster(v, f, device="cpu").cast(cam.origins, cam.dirs)
    rc = p3t.create_raycaster(v, f, backend="pallas", device="cpu")
    assert type(rc) is PallasRayCaster
    want = rc.cast(cam.origins, cam.dirs)
    assert bool((want.face_id >= 0).any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_checked_raises_inside_and_returns_outside():
    g = sphere16()
    small = debug.checked(p3t.marching_cubes_padded)
    assert small.__name__ == "marching_cubes_padded"
    with pytest.raises(debug.CheckError, match="capacity overflow"):
        small(g, 0.0, vert_capacity=8, face_capacity=8, device="cpu")
    assert not debug.enabled()
    res = small(g, 0.0, vert_capacity=2048, face_capacity=4096, device="cpu")
    assert not bool(res.overflowed)
    # outside the wrapper the same overflow raises nothing
    p3t.marching_cubes_padded(g, 0.0, vert_capacity=8, face_capacity=8,
                              device="cpu")


def test_block_returns_its_argument():
    t = torch.arange(3.0)
    tree = (t, [t * 2, {"k": MCSoupResult(t, t)}], 1.5, None)
    assert timer.block(tree) is tree
    assert timer.block(t) is t
    assert timer._cuda_devices(tree, set()) == set()


def test_raycast_kernel_names_and_the_resident_cap():
    from primitive3d_tpu.core.config import RayCastConfig as JaxConfig
    from primitive3d_tpu.kernels import raycast_kernel as jax_rk
    from primitive3d_tpu_torch.bvh import clusters

    assert rk.MISS == 3.0e38 and isinstance(rk.MISS, float)
    assert np.float32(rk.MISS) == np.float32(jax_rk.MISS)
    assert rk.CLUSTER_SIZE == clusters.CLUSTER_SIZE == jax_rk.CLUSTER_SIZE
    assert rk.ClusterBVH is clusters.ClusterBVH
    assert (RayCastConfig().mxu_max_tris == JaxConfig().mxu_max_tris
            == ClusterRayCaster.MXU_MAX_TRIS == 32_000)
    # the tiers are chosen as before: resident under the cap, stream past
    v, f = p3t.marching_cubes(sphere16(), 0.0, device="cpu")
    assert not p3t.create_raycaster(v, f, device="cpu").stream
    assert p3t.create_raycaster(v, f, device="cpu", config=RayCastConfig(
        mxu_max_tris=0)).stream
