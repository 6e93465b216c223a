#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every kernel of ``primitive3d_tpu_torch/csrc`` with nvcc and
drives five paths through the entry points a user calls, each with the
kernel launch counts set to 0 just before it and read just after:

  * the serving path (marching cubes -> cluster ray caster -> work-list
    cull -> cast) at two full-size configurations:
      - bunny: ``examples/data/bunny.npy`` (66^3) -> 13,282 vertices /
        26,560 faces -> 512x512 camera rays, resident cast tier;
      - flagship sphere: the 256^3 sphere SDF (r = 0.8 on [-1, 1]^3) ->
        1088x1920 camera rays, stream cast tier with clusters of 128;
  * the training path: one differentiable SDF-fitting step
    (``sdf_fitting_loss(..., backend="pallas")`` then ``backward()``) at the
    configuration of FLAGSHIP_r5.json and tools/flagship_probe.py: the
    256^3 sphere, a 425,984-face soup, 1088x1920 rays, target depth 1.7;
  * the large-mesh path, the scalar cluster tier: the card's bunny mesh
    subdivided 5 times by edge midpoints (tools/stream_sweep.py) into
    27,197,440 triangles, which ``create_raycaster(..., backend="pallas")``
    casts in the scalar tier by its size alone (106,240 clusters of 256,
    past the stream tier's 32,767, under a 32-wide box tree that one warp
    per ray walks), cast under the bunny's 512x512 camera; then
    ``cast_clusters(..., ordered=False)`` and ``cast_clusters_diff``
    (forward and backward) on the same mesh and rays;
  * the sharded path (``parallel/``) at world size 1 on NCCL, the group
    set up in this process: the training path's flagship step through
    ``sharded_sdf_fitting_loss`` (x-slab soup, its all-gather, the rays'
    cast, ``backward()``), ``make_sharded_cast`` of the bunny's caster and
    of the large mesh's, ``sharded_marching_cubes`` of the 256^3 sphere
    and ``sharded_marching_tetrahedra_lattice`` of the 128^3 lattice; held
    against the single-device step (loss rel 1e-5, gradient rtol 1e-4 /
    atol 1e-6), casts, ``marching_cubes`` (canonicalised) and lattice tier.
    Then the step and the sharded MC again in two processes on the one
    card over gloo with CUDA tensors (``torch.multiprocessing.spawn``),
    each launching the kernels, held against world size 1;
  * the marching-tetrahedra path, plain PyTorch that launches no kernel of
    ``csrc/`` (its launch counts must stay 0): the eager call with
    ``tet_idx`` and the gradient of sum(v ** 2) on the tet fixture
    (``examples/data/tetrahedra``, 12,045 tets -> 4,650 / 9,296), held
    against the same on the CPU; BENCH_r05.json's 128^3 Kuhn lattice
    (12,290,298 tets, sphere SDF of radius 32) in the compacted sort tier
    (57,830 / 115,656, the JAX package's counts), the lattice tier with and
    without the points (equal to it) and the eager sort over all
    73,741,788 edges (equal once trimmed); ``save_mesh`` from the card's
    tensors through ``load_mesh`` and ``native.save_ply`` (the same
    bytes); and ``native.build_lbvh`` of the bunny mesh on the host,
    walked on the card by ``bvh.traverse.cast_rays`` over the bunny's
    rays against ``native.raycast``.

It checks the outputs (exact counts, card against CPU, the flagship step's
depth against the analytic sphere and its loss and gradient norm against
FLAGSHIP_r5.json, the large mesh's frame against the bunny's and, on the
rays where they disagree, against a brute force of the large mesh; the
sharded step at world size 1 against the single step, the gradient bit for
bit), checks the JAX package's names on the card (``PallasRayCaster``
against ``create_raycaster(..., backend="pallas")`` on every bunny ray,
``timer.block`` on card tensors, ``debug.checked`` raising ``CheckError``
on an overflowing ``marching_cubes_padded``), runs three
Adam steps of the flagship fitting recipe, holds each kernel against its
plain PyTorch version on the card at the shapes its path gives it (both
cluster casts bit for bit on every ray but those a float64 witness
settles: ``raycast_kernel.cast_disputes``), casts
the level-0 bunny with the "mxu", "bruteforce" and "bvh" backends against
the cluster caster, times the kernels and the paths' stages with CUDA
events, and prints:

  * a ``stages`` JSON line: the paths' stage times (``mt``: the
    marching-tetrahedra path's, with Mtet/s; ``sharded``: the sharded
    path's beside the single-device ones, the two ranks' slowest, and a
    profile of each step; ``corner_adds``: the soup backward's eight
    ``index_add_``s on the flagship step's own cotangent, device time with
    the padding rows spread past the grid against the old layout built
    here, every padding row at cube 0, the two gradients equal);
    ``padded_backwards``: the four backwards whose misses or padding rows
    all added into one index, each on its path's own cotangent at full
    size, with those rows sent to a tail past the output, against the old
    layout built here (device and per-call ms of both, the bytes bound,
    the gradients equal after ``+ 0.0``): ``resident_planes`` (the bunny
    through ``cast_clusters_diff``'s resident tier, 512x512 rays),
    ``scalar_planes`` (the large mesh's scalar tier, recorded on its path),
    ``mesh_density`` (``marching_cubes_padded`` of the 256^3 sphere at the
    Adam steps' budgets, a seeded cotangent on its vertices),
    ``deindex_vertices`` (``render_depth``'s "mxu" de-index of that mesh,
    the cotangent back through ``triangle_matrix``), and the small
    sphere's "mxu" step as a whole in both layouts;
  * a ``kernels`` JSON line: each kernel's launches on the main paths,
    error against its plain version, its time per wrapper call (``ms``,
    CUDA events around one call, the host's part included), its own device
    time (``device_ms``: the profiler's device time of its kernels over
    back-to-back calls, per call; ``device_ms_source`` says "events" where
    the profiler saw none and events around the calls were taken instead),
    the plain version's time
    (for the scalar kernels on all ``plain_rays`` of the large frame), its
    lower bound on this card and the time of one PyTorch call that computes
    the same function, where there is one. The work-list cull
    (``stream_cull``) ports no Pallas kernel: the JAX package builds the
    lists in plain XLA, and its ``replaces`` names those lines;
  * the card's name and power limit (nvidia-smi);
  * last, ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device, or without the rest of the repository beside it, it fails before
printing any result. It never imports JAX or the JAX package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), the bound's denominators
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations per ray-triangle test of the cast kernels: three 6-term
# side products (6 mul + 5 add each), a 4-term numerator (3 mul + 3 add),
# two adds for the denominator and one division
CAST_OPS_PER_TEST = 3 * 11 + 6 + 2 + 1
BUNNY_COUNTS = (13282, 26560)
FLAGSHIP_COUNTS = (196128, 392252)  # the JAX package's counts of this grid
# the training step of tools/flagship_probe.py (stage_step) and its record
FLAGSHIP_VC, FLAGSHIP_FC = 262_144, 425_984
FLAGSHIP_R5 = dict(loss=48.77151107788086, grad_norm=0.002150929532945156)
BOX = dict(lower=(-1.0, -1.0, -1.0), upper=(1.0, 1.0, 1.0))
SERVING_KERNELS = ("mc_masks", "stream_cull", "cluster_cast_resident",
                   "cluster_cast_stream")
TRAINING_KERNELS = ("mc_masks", "stream_cull", "cluster_cast_stream",
                    "plane_scatter")
LARGE_KERNELS = ("mc_masks", "cluster_scalar_ordered", "cluster_scalar")
# the large mesh: the bunny subdivided LEVELS times, child k of face p is
# 4p + k, so face_id // 4**LEVELS is the bunny face a hit lies on
LEVELS = 5
LARGE_TRIS = BUNNY_COUNTS[1] * 4 ** LEVELS
# fp32 operations per test of the scalar kernels: a slab test is
# 6 sub + 6 mul + 6 pairwise min/max + 4 to combine them + 3 compares; a
# Möller-Trumbore test 27 mul + 18 add/sub + 1 division (its 8 compares
# not counted)
SLAB_OPS = 25
TRI_OPS = 46
# fp32 operations per (chunk, cluster) cell of the work-list cull: per axis
# 2 subtractions, the 4 corner products and 6 min / max (csrc/stream_cull.cu
# shows that these give the plain version's 4 subtractions, 8 products and
# 14 min / max bit for bit), then 4 to combine the axes, 3 compares, the
# clamp and the min of the bound
CULL_OPS_PER_CELL = 3 * (2 + 4 + 6) + 4 + 3 + 2
# the mask kernel against its plain version at shapes its tiling finds hard
# beside the paths' grids: rows of Z - 1 bytes not a multiple of 4, Z < 16,
# Y of 2 (values at the threshold, +-inf and NaN among normal ones)
MASK_EDGE_SHAPES = ((3, 7, 17), (5, 2, 3), (2, 3, 66))
# kernel symbols each wrapper launches, for the profiler's device time
DEVICE_KERNELS = {
    "mc_masks": ("mc_masks_kernel",),
    "stream_cull": ("cull_kernel",),
    "cluster_cast_resident": ("walk_kernel",),
    "cluster_cast_stream": ("walk_kernel",),
    "plane_scatter": ("key_kernel", "sum_kernel", "Memset"),
    "cluster_scalar_ordered": ("cluster_scalar_kernel",),
    "cluster_scalar": ("cluster_scalar_kernel",),
}
# large-mesh frame against the bunny's: shares that must agree, against the
# brute force (Möller-Trumbore, as the scalar tier) on hit/miss, face and
# depth; against the resident cast (Plücker sign tests, which can miss both
# faces of an edge a ray passes exactly through) on hit/miss, and on faces
# to LARGE_FACE_AGREE (the first chip run of this check: 0.998716). On every
# ray where the two meshes disagree, the frame must equal a brute force of
# the large mesh itself, so the differences are the meshes', not the walk's
LARGE_AGREE = 0.999
LARGE_FACE_AGREE = 0.998
# the marching-tetrahedra path: the tet fixture (examples/data/tetrahedra)
# and BENCH_r05.json's 128^3 Kuhn lattice (bench.py's MT section: a sphere
# SDF of radius n/4 about the centre, capacities 2^17 / 2^18), with the JAX
# package's counts
MT_FIXTURE_COUNTS = (4650, 9296)
MT_N = 128
MT_CAPS = (1 << 17, 1 << 18)
MT_COUNTS = (57830, 115656)
# the sharded path (parallel/): the flagship step, the casts, MC and MT at
# world size 1 on NCCL, then the step and MC in SHARDED_RANKS processes on
# the one card over gloo (NCCL takes one process per card)
SHARDED_KERNELS = ("mc_masks", "stream_cull", "cluster_cast_stream",
                   "plane_scatter", "cluster_cast_resident",
                   "cluster_scalar_ordered")
SHARDED_RANKS = 2
STEP_KW = dict(thresh=0.0, vert_capacity=FLAGSHIP_VC,
               face_capacity=FLAGSHIP_FC, max_dist=10.0, backend="pallas",
               **BOX)
MC_SHARD_CAPS = dict(vert_cap_per_shard=FLAGSHIP_VC,
                     face_cap_per_shard=FLAGSHIP_FC)
# the sharded step against the single-device one: tests/test_parallel.py's
# tolerances (loss relative; gradient rtol, atol)
SHARD_LOSS_REL, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 1e-5, 1e-4, 1e-6


def log(*a):
    print(*a, flush=True)


def sphere_grid(n=256, r=0.8):
    """The 256^3 sphere SDF of tools/flagship_probe.py, in float32."""
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(r) - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def small_sphere_grid(n=32):
    """An off-centre sphere: a centred one has exact mirror depth ties."""
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(0.6) - np.sqrt(
        (x - 0.13) ** 2 + (y + 0.07) ** 2 + (z - 0.05) ** 2)
    ).astype(np.float32)


def analytic_hits(o, d, centre, radius):
    """Hit mask and depth (float64) of rays against a sphere."""
    oc = o - centre
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - radius ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return (disc >= 0) & (t > 0), t


def grid_sphere(n=256, r=0.8):
    """(centre, radius) in world space of the surface of ``sphere_grid(n,
    r)`` on [-1, 1]^3. The grid samples ``linspace(-1, 1, n)`` (spacing
    2/(n-1)), while ``lower``/``upper`` place sample i at -1 + 2i/n, as the
    package's scale rule (upper - lower) / n does; so the surface is the
    radius-r sphere about the origin scaled by (n-1)/n about (-1, -1, -1).
    """
    s = (n - 1) / n
    return np.full(3, s - 1.0), r * s


def event_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() between two CUDA events."""
    from primitive3d_tpu_torch.core.timer import time_fn
    return time_fn(fn, iters=iters, warmup=warmup, device="cuda") * 1e3


def device_ms(fn, name, calls=20):
    """Device milliseconds per call of ``fn``, a wrapper that launches the
    kernel ``name``: the device time of its kernels (DEVICE_KERNELS; every
    kernel ``fn`` launches where ``name`` is None) that ``torch.profiler``
    records over ``calls`` back-to-back calls, divided by ``calls``. Where
    the profiler records none, CUDA events around the ``calls`` calls,
    divided by ``calls``. Returns (ms, source)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    keys = DEVICE_KERNELS[name] if name else ("",)
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.key for k in keys)):
            us += getattr(e, "self_device_time_total", 0.0) or 0.0
            launches += e.count
    if us > 0 and launches >= calls:
        return us / 1e3 / calls, "profiler"
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls, "events"


def backward_ms(make_loss, iters=5, warmup=1):
    """Median milliseconds of ``make_loss().backward()`` alone, between two
    CUDA events (the forward runs outside the timed span)."""
    import torch
    times = []
    for i in range(warmup + iters):
        loss = make_loss()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss.backward()
        b.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def profile_step(step, top=8, title="training step", groups=None):
    """One ``step()`` under ``torch.profiler``: logs the kernels and the
    autograd nodes with the most device time, and returns the device busy
    share of the step's wall time (None where the profiler saw no device
    time), the busy ms and, for each ``groups`` entry {name: key}, the
    device ms of the kernels whose name holds the key."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e, own):
        name = "self_device_time_total" if own else "device_time_total"
        return getattr(e, name, 0.0) or 0.0

    avgs = prof.key_averages()
    kern = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e, True) for e in kern)
    if busy_us <= 0:
        log(f"profile of one {title}: no device time seen")
        return dict(profiled_wall_ms=wall_us / 1e3, device_busy_share=None)
    for kind, rows, own in (
            ("kernels", kern, True),
            ("backward nodes", [e for e in avgs if e.key.startswith(
                "autograd::engine::evaluate_function")], False)):
        rows = sorted(rows, key=lambda e: -dev_us(e, own))[:top]
        log(f"profile of one {title}, {kind} by device ms: "
            + "; ".join(f"{e.key[:60]} {dev_us(e, own) / 1e3:.3f} x{e.count}"
                        for e in rows))
    log(f"profile of one {title}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f}), "
        f"{sum(e.count for e in kern)} kernels")
    out = dict(profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / wall_us)
    for name, key in (groups or {}).items():
        rows = [e for e in kern if key in e.key]
        out[f"{name}_device_ms"] = sum(dev_us(e, True) for e in rows) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in rows)
        log(f"profile of one {title}: {name} ({key!r} kernels) "
            f"{out[f'{name}_device_ms']:.4f} ms device over "
            f"{out[f'{name}_launches']} launches")
    return out


def needed_work(rk, bvh, o, d, depth, hit, max_dist, cells=1 << 25,
                pairs=1 << 18):
    """The work any closest-hit walk of the two-level cluster tree must do
    for rays ``o``/``d`` (R, 3) whose result is ``depth``/``hit``, counted
    from those inputs and that result, not from a kernel's walk: each ray
    slab-tests every cluster box and every sub-box it enters nearer than its
    final depth (max_dist for a miss; the winner's own box included), and
    tests every triangle of those sub-boxes.

    Returns (slab tests, triangle tests) summed over the rays, and the
    cluster boxes and sub-boxes that some ray enters, each counted once.
    """
    import torch
    R = o.shape[0]
    C, nsub = bvh.sub_boxes.shape[:2]
    best = torch.where(hit, torch.nextafter(depth, torch.full_like(
        depth, float("inf"))), torch.full_like(depth, float(max_dist)))
    inv = torch.reciprocal(d)
    row = [x.view(1, 1, R) for x in (o[:, 0], o[:, 1], o[:, 2])]
    irow = [x.view(1, 1, R) for x in (inv[:, 0], inv[:, 1], inv[:, 2])]
    used_c = torch.zeros(C, dtype=torch.bool, device=o.device)
    used_s = torch.zeros(C * nsub, dtype=torch.bool, device=o.device)
    n_c = n_s = 0
    k = max(1, cells // R)
    for s in range(0, C, k):
        e = min(s + k, C)
        ent = rk._slab_useful(bvh.boxes[None, s:e], row, irow,
                              best.view(1, 1, R))[0]  # (e - s, R)
        used_c[s:e] = ent.any(dim=1)
        n_c += int(ent.sum())
        cj, rj = ent.nonzero().unbind(1)
        for p in range(0, cj.shape[0], pairs):
            c, r = cj[p:p + pairs] + s, rj[p:p + pairs]
            one = [x[r].view(-1, 1, 1) for x in (o[:, 0], o[:, 1], o[:, 2])]
            ione = [x[r].view(-1, 1, 1) for x in (inv[:, 0], inv[:, 1],
                                                  inv[:, 2])]
            sub = rk._slab_useful(bvh.sub_boxes[c], one, ione,
                                  best[r].view(-1, 1, 1))[..., 0]
            n_s += int(sub.sum())
            flat = c[:, None] * nsub + torch.arange(nsub, device=o.device)
            used_s[flat[sub]] = True
    return (n_c + n_s, n_s * rk.SUB_SIZE, int(used_c.sum()),
            int(used_s.sum()))


def brute_force_sorted(rk, tri, o, d, max_dist, cells=1 << 25):
    """Closest hit of rays ``o``/``d`` (n, 3) against every triangle row of
    ``tri`` (T, 9) = [a, e1, e2], with the scalar kernels' own arithmetic
    (``_triangle_t``): (depth, index of a smallest t), depth max_dist and
    index -1 where no t lies below max_dist."""
    import torch
    n = o.shape[0]
    row = [o[:, q].reshape(1, 1, n) for q in range(3)]
    drow = [d[:, q].reshape(1, 1, n) for q in range(3)]
    best = torch.full((n,), float(max_dist), device=o.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    k = max(1, cells // max(n, 1))
    for s in range(0, tri.shape[0], k):
        tmin, m = rk._triangle_t(tri[None, s:s + k], row, drow)[0].min(dim=0)
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        idx = torch.where(upd, s + m, idx)
    return best, idx


def mt_lattice(n):
    """BENCH_r05.json's MT input: grid_tetrahedra(n) and the sphere SDF of
    radius n / 4 about the lattice's centre, in float32."""
    from primitive3d_tpu_torch import grid_tetrahedra
    pts, tets = grid_tetrahedra(n)
    c = (n - 1) / 2.0
    return pts, tets, ((n / 4.0) - np.linalg.norm(pts - c, axis=1)
                       ).astype(np.float32)


def mt_path(counted, v_b, f_b, origins, dirs):
    """The marching-tetrahedra path (plain PyTorch: it launches no
    hand-written kernel), PLY I/O and the native host runtime, on the card.
    Returns the path's stage times."""
    import tempfile

    import torch
    from primitive3d_tpu_torch import (load_mesh, marching_tetrahedra,
                                       marching_tetrahedra_lattice,
                                       marching_tetrahedra_padded,
                                       marching_tetrahedras, native,
                                       save_mesh)
    from primitive3d_tpu_torch.bvh.traverse import cast_rays

    data = os.path.join(ROOT, "examples", "data", "tetrahedra")
    pts, tets, sdf = (np.load(os.path.join(data, f"{k}.npy"))
                      for k in ("points", "tetrahedras", "sdfs"))
    device, n, (vc, fc) = "cuda", MT_N, MT_CAPS
    lpts, ltets, lsdf = mt_lattice(n)
    d_pts = torch.from_numpy(pts).to(device)
    d_tets = torch.from_numpy(tets).to(device)
    d_sdf = torch.from_numpy(sdf).to(device)
    l_pts = torch.from_numpy(lpts).to(device)
    l_tets = torch.from_numpy(ltets).to(device)
    l_sdf = torch.from_numpy(lsdf).to(device)
    T_l = ltets.shape[0]
    torch.cuda.synchronize()

    def fixture_step():
        p = d_pts.clone().requires_grad_()
        s = d_sdf.clone().requires_grad_()
        v, f, tid = marching_tetrahedras(p, d_tets, s, return_tet_idx=True,
                                         device=device)
        (v ** 2).sum().backward()
        return v.detach(), f, tid, p.grad, s.grad

    def drive():
        out = fixture_step()
        kw = dict(vert_capacity=vc, face_capacity=fc, device=device)
        sort = marching_tetrahedra_padded(l_pts, l_tets, l_sdf, **kw)
        ident = marching_tetrahedra_lattice(None, l_sdf, n, **kw)
        expl = marching_tetrahedra_lattice(l_pts, l_sdf, n, **kw)
        eager = marching_tetrahedra(l_pts, l_tets, l_sdf, device=device)
        return out, sort, ident, expl, eager

    # no kernel of csrc/ belongs to this path: nothing must launch
    ((v, f, tid, gp, gs), sort, ident, expl, eager), launches = counted(
        "marching-tetrahedra", (), drive)
    check(sum(launches.values()) == 0,
          f"the marching-tetrahedra path launched kernels: {launches}")
    check((v.shape[0], f.shape[0]) == MT_FIXTURE_COUNTS,
          f"MT fixture {v.shape[0]} / {f.shape[0]}, want {MT_FIXTURE_COUNTS}")
    # the same on the CPU: integers equal, positions and gradients within
    # float32 rounding of another summation order (rtol 1e-5, atol 1e-6)
    p = torch.from_numpy(pts).requires_grad_()
    s = torch.from_numpy(sdf).requires_grad_()
    v_c, f_c, tid_c = marching_tetrahedras(p, tets, s, return_tet_idx=True,
                                           device="cpu")
    (v_c ** 2).sum().backward()
    verr = float((v.cpu() - v_c.detach()).abs().max())
    gerr = [float((g.cpu() - gc).abs().max()) for g, gc in
            ((gp, p.grad), (gs, s.grad))]
    log(f"MT fixture: {v.shape[0]} verts / {f.shape[0]} faces on {device}; "
        f"against the CPU: faces and tet_idx equal "
        f"{torch.equal(f.cpu(), f_c) and torch.equal(tid.cpu(), tid_c)}, "
        f"vertices max |diff| {verr:.3g}, gradient max |diff| (points, "
        f"sdf) {gerr[0]:.3g}, {gerr[1]:.3g}")
    check(torch.equal(f.cpu(), f_c) and torch.equal(tid.cpu(), tid_c),
          "MT fixture: faces or tet_idx differ from the CPU")
    check(torch.allclose(v.cpu(), v_c.detach(), rtol=1e-6, atol=1e-6),
          "MT fixture: vertices differ from the CPU")
    check(torch.allclose(gp.cpu(), p.grad, rtol=1e-5, atol=1e-6)
          and torch.allclose(gs.cpu(), s.grad, rtol=1e-5, atol=1e-6),
          "MT fixture: gradients differ from the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mt.ply")
        save_mesh(v, f, filename=path)
        v2, f2, c2 = load_mesh(path)
        check(np.array_equal(v2, v.cpu().numpy())
              and np.array_equal(f2, f.cpu().numpy()) and (c2 == 127).all(),
              "MT fixture: the PLY does not give the mesh back")
        native.save_ply(os.path.join(tmp, "native.ply"), v, f)
        with open(path, "rb") as a, open(os.path.join(tmp, "native.ply"),
                                          "rb") as b:
            check(a.read() == b.read(), "native.save_ply differs from "
                  "save_mesh")
    log("MT fixture: save_mesh from the card's tensors round-trips through "
        "load_mesh; native.save_ply writes the same bytes")

    # the lattice: the compacted sort tier, the lattice tier with and
    # without the points, the eager (uncompacted) sort tier
    nv, nf = int(sort.num_vertices), int(sort.num_faces)
    log(f"MT {n}^3 lattice ({T_l} tets): sort tier {nv} verts / {nf} faces "
        f"(A = {min(fc, T_l)} active tets); the JAX package's: "
        f"{MT_COUNTS[0]} / {MT_COUNTS[1]}")
    check((nv, nf) == MT_COUNTS and not bool(sort.overflowed),
          f"MT lattice counts {nv} / {nf}, want {MT_COUNTS}")
    for name, r in (("identity", ident), ("explicit", expl)):
        same = all(torch.equal(getattr(r, k), getattr(sort, k)) for k in
                   ("faces", "tet_idx", "num_vertices", "num_faces"))
        err = float((r.vertices - sort.vertices).abs().max())
        log(f"MT lattice tier ({name} points) against the sort tier: "
            f"integers equal {same}, vertices max |diff| {err:.3g}")
        check(same and torch.allclose(r.vertices, sort.vertices, rtol=1e-6,
                                      atol=1e-6),
              f"MT lattice tier ({name}) differs from the sort tier")
    ev, ef = eager
    check(torch.equal(ev, sort.vertices[:nv]) and torch.equal(
        ef, sort.faces[:nf]), "MT eager lattice differs from the padded one")
    log(f"MT eager sort tier over all {6 * T_l} edges: equal to the padded "
        f"compacted one")
    del ident, expl, eager, ev, ef

    # the native runtime: a tree built on the host, walked on the device
    tris = v_b[f_b.long()]
    t0 = time.perf_counter()
    bvh = native.build_lbvh(tris, device=device)
    t_build = (time.perf_counter() - t0) * 1e3
    o = torch.as_tensor(origins).to(device)
    d = torch.as_tensor(dirs).to(device)
    depth, leaf = cast_rays(bvh, o, d, 10.0)
    fid = torch.where(leaf >= 0, bvh.prim_order[leaf.clamp(min=0).long()],
                      -1).cpu().numpy()
    t0 = time.perf_counter()
    n_depth, _, n_fid = native.raycast(bvh, origins, dirs, 10.0)
    t_ncast = (time.perf_counter() - t0) * 1e3
    agree = float((fid == n_fid).mean())
    bad = np.nonzero(fid != n_fid)[0]
    log(f"native: LBVH of {tris.shape[0]} triangles built on the host in "
        f"{t_build:.1f} ms, walked on {device} by bvh.traverse.cast_rays "
        f"over {fid.shape[0]} rays: face ids equal the native cast's "
        f"({t_ncast:.1f} ms on the host) on {agree:.6f} of rays; "
        f"{bad.shape[0]} differ: " + "; ".join(
            f"ray {q} ({fid[q]}, {float(depth[q]):.6f}) vs ({n_fid[q]}, "
            f"{n_depth[q]:.6f})" for q in bad[:20]))
    check(agree >= LARGE_AGREE, "native: the host tree walked on the card "
          "disagrees with the native cast")

    # times: medians of CUDA-event runs after one warm-up
    kw = dict(vert_capacity=vc, face_capacity=fc)
    times = dict(
        fixture_eager_ms=event_ms(lambda: marching_tetrahedra(
            d_pts, d_tets, d_sdf), iters=10, warmup=1),
        fixture_backward_ms=backward_ms(lambda: (marching_tetrahedra(
            d_pts.clone().requires_grad_(), d_tets,
            d_sdf.clone().requires_grad_())[0] ** 2).sum()),
        lattice_sort_ms=event_ms(lambda: marching_tetrahedra_padded(
            l_pts, l_tets, l_sdf, **kw), iters=5, warmup=1),
        lattice_identity_ms=event_ms(lambda: marching_tetrahedra_lattice(
            None, l_sdf, n, **kw), iters=10, warmup=1),
        lattice_explicit_ms=event_ms(lambda: marching_tetrahedra_lattice(
            l_pts, l_sdf, n, **kw), iters=10, warmup=1),
        lattice_eager_ms=event_ms(lambda: marching_tetrahedra(
            l_pts, l_tets, l_sdf), iters=3, warmup=1),
        native_build_ms=t_build, native_host_cast_ms=t_ncast)
    rates = {k.replace("_ms", "_mtet_per_s"): (tets.shape[0] if "fixture" in k
                                              else T_l) / (ms * 1e3)
             for k, ms in times.items() if not k.startswith("native")}
    log("path marching tetrahedra: " + ", ".join(
        f"{k} {x:.3f}" for k, x in {**times, **rates}.items()))
    busy = {}
    for name, fn in (
            ("fixture_step", fixture_step),
            ("lattice_sort", lambda: marching_tetrahedra_padded(
                l_pts, l_tets, l_sdf, **kw)),
            ("lattice_identity", lambda: marching_tetrahedra_lattice(
                None, l_sdf, n, **kw)),
            ("lattice_eager", lambda: marching_tetrahedra(
                l_pts, l_tets, l_sdf))):
        prof = profile_step(fn, top=6, title=f"MT {name} call")
        busy[f"{name}_device_busy_share"] = prof["device_busy_share"]
    return dict(times, **rates, **busy, fixture_tets=tets.shape[0],
                lattice_tets=T_l)


def flagship_inputs():
    """The flagship step's grid, rays and target on the card."""
    import torch
    from primitive3d_tpu_torch.render.camera import camera_rays

    cam = camera_rays(1088, 1920, (0.0, 0.0, 2.5), (0.0, 0.0, 0.0))
    o = torch.from_numpy(cam.origins).cuda()
    return (torch.from_numpy(sphere_grid()).cuda(), o,
            torch.from_numpy(cam.dirs).cuda(),
            torch.full((o.shape[0],), 1.7, dtype=torch.float32, device="cuda"))


def sharded_step(mesh, dens0, o, d, t):
    """One sharded flagship step: (loss, the grid's gradient)."""
    from primitive3d_tpu_torch.parallel.pipeline import \
        sharded_sdf_fitting_loss

    dens = dens0.clone().requires_grad_()
    loss = sharded_sdf_fitting_loss(mesh, dens, o, d, t, **STEP_KW)
    loss.backward()
    return loss.detach(), dens.grad


def single_step(dens0, o, d, t):
    """The same step on the single-device path."""
    from primitive3d_tpu_torch import sdf_fitting_loss

    dens = dens0.clone().requires_grad_()
    loss = sdf_fitting_loss(dens, o, d, t, **STEP_KW)
    loss.backward()
    return loss.detach(), dens.grad


def sharded_rank(rank, tmp):
    """One of SHARDED_RANKS processes on the one card, joined over gloo
    with CUDA tensors: the flagship step and the 256^3 sharded MC, with
    their times and this process's kernel launches, written to ``tmp``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from primitive3d_tpu_torch.kernels import _build
    from primitive3d_tpu_torch.parallel.marching_cubes import (
        gather_sharded_mesh, sharded_marching_cubes)
    from primitive3d_tpu_torch.parallel.mesh import (
        all_gather, initialize_distributed, make_mesh)

    initialize_distributed(init_method=f"file://{tmp}/gloo",
                           num_processes=SHARDED_RANKS, process_id=rank,
                           device="cuda", backend="gloo")
    try:
        mesh_d = make_mesh(axis_name="data")
        mesh_x = make_mesh(axis_name="x")
        dens, o, d, t = flagship_inputs()
        _build.reset_launches()
        loss, grad = sharded_step(mesh_d, dens, o, d, t)
        mc = sharded_marching_cubes(mesh_x, dens, 0.0, **MC_SHARD_CAPS)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _build.KERNELS}
        v, f = gather_sharded_mesh(mc)
        # a rank's soup: fcap faces of the sharded loss
        soup = torch.zeros((-(-FLAGSHIP_FC // (SHARDED_RANKS * 128)) * 128,
                            3, 3), device="cuda")
        times = dict(
            step_ms=event_ms(lambda: sharded_step(mesh_d, dens, o, d, t),
                             iters=5, warmup=1),
            all_gather_ms=event_ms(lambda: all_gather(mesh_d, soup),
                                   iters=10),
            mc_ms=event_ms(lambda: sharded_marching_cubes(
                mesh_x, dens, 0.0, **MC_SHARD_CAPS), iters=5, warmup=1))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), loss=loss.item(),
                 grad=grad.cpu().numpy(), v=v, f=f,
                 overflowed=bool(mc.overflowed))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(dict(launches=launches, backend=dist.get_backend(),
                           **times), fh)
    finally:
        dist.destroy_process_group()


def sharded_path(counted, single, rc_b, rc_l, o_b, d_b):
    """The sharded layer (parallel/) on the card, then checks and times.

    ``single`` holds the single-device results it is held against: the
    training path's step (loss, grad) and the casts of the serving and
    large-mesh paths (hits_b, hits_l). World size 1 on NCCL first, counted;
    then SHARDED_RANKS processes over gloo. Returns the path's launch counts
    and stage times."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from primitive3d_tpu_torch import (marching_cubes, marching_cubes_padded,
                                       marching_tetrahedra_lattice)
    from primitive3d_tpu_torch.core.canonical import canonicalize_mesh
    from primitive3d_tpu_torch.kernels import mc_masks as mk
    from primitive3d_tpu_torch.parallel.marching_cubes import (
        gather_sharded_mesh, sharded_marching_cubes)
    from primitive3d_tpu_torch.parallel.marching_tetrahedra import \
        sharded_marching_tetrahedra_lattice
    from primitive3d_tpu_torch.parallel.mesh import (
        all_gather, initialize_distributed, make_mesh)
    from primitive3d_tpu_torch.parallel.raycast import make_sharded_cast

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    initialize_distributed(init_method=f"file://{tmp}/nccl",
                           num_processes=1, process_id=0, device="cuda")
    check(dist.get_backend() == "nccl", "world size 1 is not on NCCL")
    mesh_d = make_mesh(axis_name="data")
    mesh_x = make_mesh(axis_name="x")
    dens, o_f, d_f, t_f = flagship_inputs()
    l_sdf = torch.from_numpy(mt_lattice(MT_N)[2]).cuda()
    mt_kw = dict(vert_cap_per_shard=MT_CAPS[0], face_cap_per_shard=MT_CAPS[1])
    cast_b = make_sharded_cast(rc_b, mesh_d)
    cast_l = make_sharded_cast(rc_l, mesh_d)
    torch.cuda.synchronize()

    def drive():
        step = sharded_step(mesh_d, dens, o_f, d_f, t_f)
        hb, hl = cast_b(o_b, d_b), cast_l(o_b, d_b)
        mc = sharded_marching_cubes(mesh_x, dens, 0.0, **MC_SHARD_CAPS)
        mt = sharded_marching_tetrahedra_lattice(mesh_x, l_sdf, MT_N, **mt_kw)
        return step, hb, hl, mc, mt

    ((loss, grad), hb, hl, mc, mt), launches = counted(
        "sharded", SHARDED_KERNELS, drive)

    # the step against the single-device step of the training path, and
    # against FLAGSHIP_r5.json as that step is
    loss_v, loss_1 = loss.item(), single["loss"].item()
    grad_1 = single["grad"]
    gerr = float((grad - grad_1).abs().max())
    close = torch.allclose(grad, grad_1, rtol=SHARD_GRAD_RTOL,
                           atol=SHARD_GRAD_ATOL)
    gnorm = float(grad.norm())
    gaps = dict(loss=abs(loss_v / FLAGSHIP_R5["loss"] - 1),
                grad_norm=abs(gnorm / FLAGSHIP_R5["grad_norm"] - 1))
    log(f"sharded step (world size 1, NCCL): loss {loss_v!r} against the "
        f"single-device {loss_1!r} (rel {abs(loss_v / loss_1 - 1):.3e}); "
        f"gradient max |diff| {gerr:.3g}, allclose {close}; bit-equal: loss "
        f"{loss_v == loss_1}, gradient {torch.equal(grad, grad_1)}; "
        f"FLAGSHIP_r5 gaps: loss {gaps['loss']:.3e}, |g| "
        f"{gaps['grad_norm']:.3e}")
    check(abs(loss_v / loss_1 - 1) <= SHARD_LOSS_REL and close,
          "sharded step differs from the single-device step")
    check(torch.equal(grad, grad_1), "sharded step at world size 1: the "
          "gradient is not the single-device step's bit for bit")
    check(gaps["loss"] <= 0.01 and gaps["grad_norm"] <= 0.10,
          "sharded step: loss or |g| too far from FLAGSHIP_r5.json")
    # the casts against the single-device casts
    for name, h, ref in (("bunny", hb, single["hits_b"]),
                         ("27M-triangle mesh", hl, single["hits_l"])):
        same = torch.equal(h.face_id, ref.face_id)
        derr = float((h.depth - ref.depth).abs().max())
        log(f"sharded cast, {name}: face ids equal {same}, depth max |diff| "
            f"{derr:.3g}")
        check(same and torch.allclose(h.depth, ref.depth, rtol=0, atol=1e-6),
              f"sharded cast of the {name} differs from the single cast")
    # the masks at the shard's slab shape (Xs + 1, Y, Z): the last rank's
    # halo is its own last row
    slab = torch.cat([dens, dens[-1:]])
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(
        mk.fused_masks(slab, 0.0), mk.fused_masks_plain(slab, 0.0)))
    log(f"mc_masks on the {tuple(slab.shape)} slab: max |diff| against its "
        f"plain version {err}")
    check(err == 0, "mc_masks differs from its plain version on the slab")
    # MC: the gathered mesh is the port's marching_cubes, reordered
    check(not bool(mc.overflowed), "sharded MC overflowed")
    v_s, f_s = gather_sharded_mesh(mc)
    v_1, f_1 = marching_cubes(dens, 0.0)
    (va, fa), (vb, fb) = (canonicalize_mesh(v, f) for v, f in (
        (v_s, f_s), (v_1.cpu().numpy(), f_1.cpu().numpy())))
    same = va.shape == vb.shape and fa.shape == fb.shape and np.array_equal(
        fa, fb)
    verr = float(np.abs(va - vb).max()) if same else float("inf")
    log(f"sharded MC 256^3: {v_s.shape[0]} verts / {f_s.shape[0]} faces; "
        f"canonicalised against marching_cubes: faces equal {same}, "
        f"vertices max |diff| {verr:.3g}")
    check(same and verr <= 1e-4, "sharded MC differs from marching_cubes")
    # MT: the JAX package's counts and the single-device lattice tier
    ref = marching_tetrahedra_lattice(None, l_sdf, MT_N,
                                      vert_capacity=MT_CAPS[0],
                                      face_capacity=MT_CAPS[1])
    nv, nf = int(ref.num_vertices), int(ref.num_faces)
    v_m, f_m = gather_sharded_mesh(mt)
    same = (np.array_equal(f_m, ref.faces[:nf].cpu().numpy())
            and v_m.shape[0] == nv)
    verr = float(np.abs(v_m - ref.vertices[:nv].cpu().numpy()).max())
    log(f"sharded MT {MT_N}^3 lattice: {v_m.shape[0]} / {f_m.shape[0]} "
        f"(the JAX package's {MT_COUNTS[0]} / {MT_COUNTS[1]}); against the "
        f"lattice tier: faces equal {same}, vertices max |diff| {verr:.3g}")
    check((v_m.shape[0], f_m.shape[0]) == MT_COUNTS and same
          and verr <= 1e-6 and not bool(mt.overflowed),
          "sharded MT differs from the lattice tier")

    # times, each sharded stage beside its single-device one; the
    # all-gather of a soup of fcap faces
    soup = torch.zeros((FLAGSHIP_FC, 3, 3), device="cuda")
    # the two steps alternate, twice, against the host's drift
    steps = [event_ms(fn, iters=5) for fn in (
        lambda: sharded_step(mesh_d, dens, o_f, d_f, t_f),
        lambda: single_step(dens, o_f, d_f, t_f)) * 2]
    times = dict(
        step_ms=min(steps[0::2]), single_step_ms=min(steps[1::2]),
        all_gather_ms=event_ms(lambda: all_gather(mesh_d, soup), iters=20),
        cast_bunny_ms=event_ms(lambda: cast_b(o_b, d_b), iters=10),
        single_cast_bunny_ms=event_ms(lambda: rc_b.cast(o_b, d_b),
                                      iters=10),
        cast_large_ms=event_ms(lambda: cast_l(o_b, d_b), iters=10),
        single_cast_large_ms=event_ms(lambda: rc_l.cast(o_b, d_b),
                                      iters=10),
        mc_ms=event_ms(lambda: sharded_marching_cubes(
            mesh_x, dens, 0.0, **MC_SHARD_CAPS), iters=5),
        single_mc_ms=event_ms(lambda: marching_cubes_padded(
            dens, 0.0, vert_capacity=FLAGSHIP_VC, face_capacity=FLAGSHIP_FC),
            iters=5),
        mt_ms=event_ms(lambda: sharded_marching_tetrahedra_lattice(
            mesh_x, l_sdf, MT_N, **mt_kw), iters=5),
        single_mt_ms=event_ms(lambda: marching_tetrahedra_lattice(
            None, l_sdf, MT_N, vert_capacity=MT_CAPS[0],
            face_capacity=MT_CAPS[1]), iters=5))
    log("path sharded (world size 1, NCCL): " + ", ".join(
        f"{k} {x:.3f}" for k, x in times.items()) + "; the steps, "
        "sharded then single, twice: " + ", ".join(f"{x:.3f}" for x in steps))
    dist.destroy_process_group()

    # SHARDED_RANKS processes on the one card over gloo
    t0 = time.perf_counter()
    mp.spawn(sharded_rank, args=(tmp,), nprocs=SHARDED_RANKS)
    t_spawn = time.perf_counter() - t0
    ranks = []
    for r in range(SHARDED_RANKS):
        out = dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            out.update(json.load(fh))
        ranks.append(out)
    grad_c = grad.cpu().numpy()
    for r, out in enumerate(ranks):
        lr = float(out["loss"])
        gerr = float(np.abs(out["grad"] - grad_c).max())
        close = np.allclose(out["grad"], grad_c, rtol=SHARD_GRAD_RTOL,
                            atol=SHARD_GRAD_ATOL)
        same_mc = (np.array_equal(out["f"], f_s)
                   and out["v"].shape == v_s.shape)
        merr = float(np.abs(out["v"] - v_s).max()) if same_mc else np.inf
        missing = [k for k in SHARDED_KERNELS[:4]
                   if out["launches"][k] == 0]
        log(f"rank {r} of {SHARDED_RANKS} ({out['backend']}, CUDA tensors): "
            f"loss {lr!r} (rel {abs(lr / loss_v - 1):.3e} to world size 1), "
            f"gradient max |diff| {gerr:.3g}, allclose {close}; MC faces "
            f"equal {same_mc}, vertices max |diff| {merr:.3g}; step "
            f"{out['step_ms']:.3f} ms, soup all-gather "
            f"{out['all_gather_ms']:.3f} ms, MC {out['mc_ms']:.3f} ms; "
            f"launches {out['launches']}")
        check(abs(lr / loss_v - 1) <= SHARD_LOSS_REL and close,
              f"rank {r}: the {SHARDED_RANKS}-rank step differs from world "
              f"size 1")
        check(same_mc and merr <= 1e-6 and not out["overflowed"],
              f"rank {r}: the {SHARDED_RANKS}-rank MC differs from world "
              f"size 1")
        check(not missing, f"rank {r}: kernels {missing} were not launched")
    check(all(np.array_equal(out["grad"], ranks[0]["grad"])
              for out in ranks), "the ranks' gradients differ")
    tmp_dir.cleanup()
    times.update({f"ranks{SHARDED_RANKS}_{k}": max(out[k] for out in ranks)
                  for k in ("step_ms", "all_gather_ms", "mc_ms")},
                 ranks_spawn_s=t_spawn, ranks=SHARDED_RANKS)
    log(f"path sharded ({SHARDED_RANKS} ranks, gloo, one card; slowest "
        f"rank): step {times[f'ranks{SHARDED_RANKS}_step_ms']:.3f} ms, "
        f"all-gather {times[f'ranks{SHARDED_RANKS}_all_gather_ms']:.3f} ms, "
        f"MC {times[f'ranks{SHARDED_RANKS}_mc_ms']:.3f} ms; the processes "
        f"took {t_spawn:.1f} s")
    return launches, times


def sharded_profiles():
    """One sharded step (world size 1, NCCL) and one single-device step
    under the profiler. Run last: in a run that profiled inside an NCCL
    group before the kernel rows, the rows' later profiler sessions saw no
    device time of the hand-written kernels."""
    import tempfile

    import torch.distributed as dist
    from primitive3d_tpu_torch.parallel.mesh import (initialize_distributed,
                                                     make_mesh)

    dens, o, d, t = flagship_inputs()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method=f"file://{tmp}/nccl",
                               num_processes=1, process_id=0, device="cuda")
        try:
            mesh = make_mesh(axis_name="data")
            for name, fn in (("sharded", lambda: sharded_step(mesh, dens, o,
                                                              d, t)),
                             ("single", lambda: single_step(dens, o, d, t))):
                prof = profile_step(fn, title=f"{name} flagship step")
                out.update({f"{name}_{k}": x for k, x in prof.items()})
        finally:
            dist.destroy_process_group()
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def old_planes_select(idx, keep, g, n):
    """The resident tier's old backward (``_PlanesSelect`` before its
    tail): the hit rays' cotangents added at ``max(prim, 0)`` with
    ``index_add_``, every missed ray a zero row at plane 0."""
    import torch
    out = g.new_zeros((n,) + g.shape[1:])
    return out.index_add_(0, idx.clamp(min=0).long(),
                          torch.where(keep[:, None], g, 0.0))


def old_index_backward(idx, keep, g, n):
    """The other sites' old backward: autograd's index backward of
    ``src[idx]`` (``index_put_`` with accumulate, which sorts the index and
    sums each run of equal indices in one warp), every dropped row at its
    forward index. The indexed mesh ran it once per column; here it runs
    once over both."""
    out = g.new_zeros((n,) + g.shape[idx.dim():])
    return out.index_put_((idx.clamp(min=0),), g, accumulate=True)


def padded_backward(name, call, old, mcmod):
    """One site's backward on its path's recorded ``_tail_adds`` call
    ``(idx, keep, g, n)`` against the old layout ``old``: checks that the
    dropped rows (``keep`` false) have a zero cotangent and distinct tail
    slots past the output, and that the two gradients are equal after
    ``+ 0.0`` with both computed under ``torch.use_deterministic_algorithms``
    (``index_add_`` then sorts and sums in index order, as ``index_put_``
    does; its atomics add a row's several cotangents in no fixed order), and
    the atomics' result within 1e-5 of the largest entry of it. Returns the
    stage entry: per-call and device ms of both, and the bytes bound."""
    import torch

    idx, keep, g, n = call
    drop = ~keep
    nd = int(drop.sum())
    check(nd > 0 and bool((g[drop] == 0).all()),
          f"{name}: no dropped row, or a dropped row's cotangent is not 0")
    at = mcmod._tail_index(idx, keep, n)[drop]
    check(bool((at >= n).all()) and at.unique().numel() == at.numel(),
          f"{name}: a tail slot repeats or lies inside the output")
    one_index = idx.clamp(min=0)[drop].reshape(nd, -1).unique(
        dim=0).shape[0] == 1

    def new_fn():
        return mcmod._tail_adds(idx, keep, g, n)

    def old_fn():
        return old(idx, keep, g, n)

    torch.use_deterministic_algorithms(True)
    try:
        new_d, old_d, again = new_fn(), old_fn(), new_fn()
    finally:
        torch.use_deterministic_algorithms(False)
    check(torch.equal(new_d + 0.0, old_d + 0.0) and torch.equal(new_d, again),
          f"{name}: the gradient differs from the old layout's")
    scale = float(new_d.abs().max())
    drift = float((new_fn() - new_d).abs().max())
    check(scale > 0 and drift <= 1e-5 * scale,
          f"{name}: the atomics' gradient is {drift} from the sorted one")
    row = g.shape[idx.dim():].numel()
    out = dict(rows=idx.shape[0], dropped=nd, output_rows=n,
               old_dropped_at_one_index=one_index,
               bit_equal=torch.equal(new_d, old_d),
               atomics_max_abs_diff=drift, max_abs=scale,
               bound_ms=(nbytes(idx, keep, g) + n * row * 4)
               / HBM_BYTES_PER_S * 1e3)
    del new_d, old_d, again
    for key, fn in (("new", new_fn), ("old", old_fn)):
        out[f"{key}_ms"] = event_ms(fn, iters=10)
        out[f"{key}_device_ms"], out[f"{key}_device_src"] = device_ms(fn,
                                                                      None)
    log(f"padded backward {name}: {idx.shape[0]} rows, {nd} dropped (the "
        f"old layout's at one index: {one_index}) into {n} output rows; "
        f"equal to the old layout after + 0.0 (bit-equal "
        f"{out['bit_equal']}), atomics within {drift:.3g} of the sorted "
        f"sum; device {out['new_device_ms']:.4f} ms "
        f"({out['new_device_src']}) against the old layout's "
        f"{out['old_device_ms']:.4f} ms ({out['old_device_src']}), per "
        f"call {out['new_ms']:.4f} against {out['old_ms']:.4f} ms; bound "
        f"{out['bound_ms']:.4f} ms (bytes)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from primitive3d_tpu_torch import (create_raycaster, marching_cubes,
                                       marching_cubes_soup, render_depth,
                                       sdf_fitting_loss)
    from primitive3d_tpu_torch.bvh.clusters import build_cluster_tree
    from primitive3d_tpu_torch.core.config import RayCastConfig
    from primitive3d_tpu_torch.geometry.triangle import subdivide
    from primitive3d_tpu_torch.kernels import _build
    from primitive3d_tpu_torch.kernels import mc_masks as mk
    from primitive3d_tpu_torch.kernels import raycast_kernel as rk
    from primitive3d_tpu_torch.ops import marching_cubes as mcmod
    from primitive3d_tpu_torch.ops.marching_cubes import (
        _counts, marching_cubes_counts)
    from primitive3d_tpu_torch.raycast import (ClusterRayCaster,
                                               _finish_hits_fin)
    from primitive3d_tpu_torch.render.camera import camera_rays

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # the all-pairs cast's sign test needs full fp32 products
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    # -- 1. build every kernel from the sources in the checkout ------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(_build.sources())}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {src}: {line.strip()}")

    # -- 2. inputs ----------------------------------------------------------
    bunny = np.load(os.path.join(ROOT, "examples", "data", "bunny.npy"))
    sphere = sphere_grid()
    cam_b = camera_rays(512, 512, origin=(0.5, 0.5, -1.5),
                        look_at=(0.5, 0.5, 0.5), fov_y=35.0)
    cam_f = camera_rays(1088, 1920, (0.0, 0.0, 2.5), (0.0, 0.0, 0.0))
    sphere_dev = torch.from_numpy(sphere).to(dev)
    o_f = torch.from_numpy(cam_f.origins).to(dev)
    d_f = torch.from_numpy(cam_f.dirs).to(dev)
    R_f = o_f.shape[0]
    target_f = torch.full((R_f,), 1.7, dtype=torch.float32, device=dev)
    step_kw = STEP_KW
    torch.cuda.synchronize()

    def counted(path, names, drive):
        """Run ``drive`` with every launch count at 0; check that each
        kernel of ``names`` launched."""
        _build.reset_launches()
        out = drive()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in _build.KERNELS}
        log(f"{path} path launches: {counts}")
        for name in names:
            check(counts[name] > 0,
                  f"kernel {name} was not launched on the {path} path")
        return out, counts

    # -- 3. the serving path, once, counted ---------------------------------
    def serve():
        v_b, f_b = marching_cubes(bunny, 0.0, scale=1.0)
        rc_b = create_raycaster(v_b, f_b, backend="pallas")
        hits_b = rc_b.cast(cam_b.origins, cam_b.dirs)
        v_f, f_f = marching_cubes(sphere_dev, 0.0, scale=(-1.0, 1.0))
        rc_f = create_raycaster(v_f, f_f, backend="pallas")
        hits_f = rc_f.cast(cam_f.origins, cam_f.dirs)
        return v_b, f_b, rc_b, hits_b, v_f, f_f, rc_f, hits_f

    (v_b, f_b, rc_b, hits_b, v_f, f_f, rc_f, hits_f), serving = counted(
        "serving", SERVING_KERNELS, serve)

    # -- 3b. the training path, once, counted: one flagship step -----------
    # the forward cast's, the backward plane scatter's and the soup
    # backward's corner adds' inputs are kept for the checks
    stream_args, scatter_args, corner_args = [], [], []
    cluster_cast_stream, plane_scatter = rk.cluster_cast_stream, \
        rk.plane_scatter
    corner_adds = mcmod._corner_adds

    def recording_stream(*args, **kw):
        stream_args.append((args, kw))
        return cluster_cast_stream(*args, **kw)

    def recording_scatter(*args):
        scatter_args.append(args)
        return plane_scatter(*args)

    def recording_corners(*args):
        corner_args.append(args)
        return corner_adds(*args)

    def train_step():
        dens = sphere_dev.clone().requires_grad_()
        loss = sdf_fitting_loss(dens, o_f, d_f, target_f, **step_kw)
        loss.backward()
        return loss, dens.grad

    rk.cluster_cast_stream = recording_stream
    rk.plane_scatter = recording_scatter
    mcmod._corner_adds = recording_corners
    try:
        (loss_f, grad_f), training = counted("training", TRAINING_KERNELS,
                                             train_step)
    finally:
        rk.cluster_cast_stream = cluster_cast_stream
        rk.plane_scatter = plane_scatter
        mcmod._corner_adds = corner_adds
    check(len(stream_args) == 1, "the flagship forward ran no stream cast")
    check(len(scatter_args) == 1, "the flagship backward ran no plane scatter")
    check(len(corner_args) == 1, "the flagship backward ran no corner adds")

    # -- 3c. the large-mesh path, once, counted -------------------------------
    o_b = torch.from_numpy(cam_b.origins).to(dev)
    d_b = torch.from_numpy(cam_b.dirs).to(dev)

    def serve_large():
        v0, f0 = marching_cubes(bunny, 0.0, scale=1.0)
        t = v0[f0.long()]
        for _ in range(LEVELS):
            t = subdivide(t)
        v_l = t.reshape(-1, 3)
        f_l = torch.arange(v_l.shape[0], device=dev).reshape(-1, 3)
        rc_l = create_raycaster(v_l, f_l, backend="pallas")
        hits_l = rc_l.cast(cam_b.origins, cam_b.dirs)
        unordered = rk.cast_clusters(rc_l.cbvh, o_b, d_b, ordered=False)
        tris_g = rc_l.triangles.clone().requires_grad_()
        depth_g, prim_g = rk.cast_clusters_diff(tris_g, o_b, d_b)
        torch.where(prim_g >= 0, depth_g, 0.0).sum().backward()
        return (v_l, f_l, rc_l, hits_l, unordered,
                (depth_g.detach(), prim_g, tris_g.grad))

    tail_adds = mcmod._tail_adds

    def recorded(module, drive):
        """``drive()`` and the ``_tail_adds`` calls it made (patched in
        ``module``)."""
        calls = []

        def rec(*args):
            calls.append(args)
            return tail_adds(*args)

        setattr(module, "_tail_adds", rec)
        try:
            out = drive()
        finally:
            setattr(module, "_tail_adds", tail_adds)
        return out, calls

    # the scalar tier's plane gather's backward (its _tail_adds call) is
    # kept for the padded_backwards stage
    ((v_l, f_l, rc_l, hits_l, (t_u, i_u), (depth_g, prim_g, grad_g)),
     large), tail_args = recorded(mcmod, lambda: counted(
         "large-mesh", LARGE_KERNELS, serve_large))
    check(len(tail_args) == 1, "the large mesh's backward ran no tail adds")

    # -- 3d. the sharded path, once, counted, then its checks and times ----
    sharded, sharded_times = sharded_path(
        counted, dict(loss=loss_f, grad=grad_f, hits_b=hits_b,
                      hits_l=hits_l), rc_b, rc_l, o_b, d_b)

    # -- 4. what came out is right -----------------------------------------
    check((v_b.shape[0], f_b.shape[0]) == BUNNY_COUNTS,
          f"bunny mesh {v_b.shape[0]} / {f_b.shape[0]}, want {BUNNY_COUNTS}")
    v_c, f_c = marching_cubes(bunny, 0.0, scale=1.0, cpu=True)
    check(torch.equal(f_b.cpu(), f_c), "bunny faces differ from cpu=True")
    check(torch.allclose(v_b.cpu(), v_c, rtol=0, atol=1e-6),
          "bunny vertices differ from cpu=True")
    check(not rc_b.stream and rc_f.stream, "tiers: bunny resident, "
          "flagship stream")
    nv_c, nf_c = marching_cubes_counts(sphere, 0.0, device="cpu")
    check((v_f.shape[0], f_f.shape[0]) == (int(nv_c), int(nf_c)),
          "flagship counts differ from the CPU counts")
    log(f"flagship mesh: {v_f.shape[0]} verts / {f_f.shape[0]} faces "
        f"(CPU counts {int(nv_c)} / {int(nf_c)}; the JAX package's records: "
        f"{FLAGSHIP_COUNTS[0]} / {FLAGSHIP_COUNTS[1]}); "
        f"{rc_f.cbvh.num_clusters} clusters of {rc_f.cbvh.cluster_size}")
    for name, hits, R, rc in (("bunny", hits_b, 512 * 512, rc_b),
                              ("flagship", hits_f, 1088 * 1920, rc_f)):
        check(hits.depth.shape == (R,) and hits.normals.shape == (R, 3)
              and hits.face_id.shape == (R,), f"{name}: output shapes")
        check(bool(torch.isfinite(hits.depth).all()
                   and torch.isfinite(hits.normals).all()),
              f"{name}: non-finite output")
        fid = hits.face_id
        check(bool(((fid >= -1) & (fid < rc.num_triangles)).all()),
              f"{name}: face ids out of range")
        frac = float((fid >= 0).float().mean())
        check(0.05 < frac < 0.95, f"{name}: hit fraction {frac}")
        log(f"{name}: hit fraction {frac:.4f}")
    # the whole slice on a small off-centre sphere: card against CPU
    g = small_sphere_grid()
    cam_s = camera_rays(64, 64, (0.1, 0.2, 2.5), (0.0, 0.0, 0.0))
    for mt in (32_000, 0):
        outs = []
        for device in ("cuda", "cpu"):
            v, f = marching_cubes(g, 0.0, scale=(-1.0, 1.0), device=device)
            h = create_raycaster(v, f, backend="pallas", device=device,
                                 config=RayCastConfig(mxu_max_tris=mt)
                                 ).cast(cam_s.origins, cam_s.dirs)
            outs.append([x.cpu() for x in h])
        same = outs[0][2] == outs[1][2]
        check(float(same.float().mean()) >= 0.999,
              "small sphere: face ids differ between card and CPU")
        check(torch.allclose(outs[0][0][same], outs[1][0][same], rtol=1e-5,
                             atol=1e-6), "small sphere: depth differs")
    log("small sphere: card equals CPU at both tiers")
    # the bunny frame: the caster on the CPU, on the card's mesh
    t0 = time.perf_counter()
    h_cpu = create_raycaster(v_b.cpu(), f_b.cpu(), backend="pallas",
                             device="cpu").cast(cam_b.origins, cam_b.dirs)
    same_id = int((hits_b.face_id.cpu() == h_cpu.face_id).sum())
    log(f"bunny: the card's cast against the CPU's "
        f"({time.perf_counter() - t0:.1f} s): face ids equal on {same_id} of "
        f"{h_cpu.face_id.shape[0]} rays")
    check(same_id == h_cpu.face_id.shape[0]
          and torch.allclose(hits_b.depth.cpu(), h_cpu.depth, rtol=1e-6,
                             atol=1e-6)
          and torch.allclose(hits_b.normals.cpu(), h_cpu.normals, rtol=0,
                             atol=1e-6),
          "bunny: the card's cast differs from the CPU's")

    # -- 4a. the JAX package's names, on the card: PallasRayCaster is the
    # cluster caster, timer.block waits on card tensors and returns them,
    # debug.checked raises on an overflow of the card's extraction
    from primitive3d_tpu_torch import marching_cubes_padded
    from primitive3d_tpu_torch.core import debug, timer
    from primitive3d_tpu_torch.raycast import PallasRayCaster

    h_p = PallasRayCaster(v_b, f_b).cast(cam_b.origins, cam_b.dirs)
    h_c = create_raycaster(v_b, f_b, backend="pallas").cast(cam_b.origins,
                                                            cam_b.dirs)
    check(timer.block(h_p) is h_p, "timer.block did not return its argument")
    same_p = all(torch.equal(a, b) for a, b in zip(h_p, h_c))
    check(same_p and torch.equal(h_p.face_id, hits_b.face_id),
          "PallasRayCaster differs from create_raycaster(backend='pallas')")
    try:
        debug.checked(marching_cubes_padded)(sphere_dev, 0.0,
                                             vert_capacity=8, face_capacity=8)
        raised = "nothing"
    except debug.CheckError as e:
        raised = f"CheckError: {e}"
    check(raised.startswith("CheckError") and not debug.enabled(),
          f"debug.checked on an overflowing extraction raised {raised}")
    log(f"names on the card: PallasRayCaster equals create_raycaster("
        f"backend='pallas') on all {h_p.face_id.shape[0]} bunny rays "
        f"(depth, normals and face ids bit for bit); timer.block returned "
        f"its argument; debug.checked(marching_cubes_padded) on the 256^3 "
        f"sphere at 8 / 8 raised {raised}")
    del h_p, h_c

    # -- 4c. the large-mesh frame is the bunny's ----------------------------
    C_l, S_l = rc_l.cbvh.tri_data.shape[:2]
    check(rc_l.num_triangles == LARGE_TRIS and not rc_l.use_mxu
          and (C_l, S_l) == (-(-LARGE_TRIS // 256), 256),
          f"large mesh: {rc_l.num_triangles} triangles, {C_l} clusters of "
          f"{S_l}, scalar tier {not rc_l.use_mxu}")
    fid_l, fid_0 = hits_l.face_id, hits_b.face_id
    check(bool(torch.isfinite(hits_l.depth).all()
               and torch.isfinite(hits_l.normals).all())
          and bool(((fid_l >= -1) & (fid_l < LARGE_TRIS)).all()),
          "large mesh: non-finite output or face ids out of range")
    # two yardsticks at level 0: the resident cast of the serving path, and
    # the brute force, whose Möller-Trumbore test is the scalar tier's
    hits_bf = create_raycaster(v_b, f_b, backend="bruteforce").cast(
        cam_b.origins, cam_b.dirs)
    agreement = {}
    for name, ref in (("resident cast", hits_b), ("brute force", hits_bf)):
        fid_r = ref.face_id
        both = (fid_l >= 0) & (fid_r >= 0)
        hm = float(((fid_l >= 0) == (fid_r >= 0)).float().mean())
        same_face = (fid_l // 4 ** LEVELS == fid_r) & both
        face = float(same_face.sum()) / max(1, int(both.sum()))
        rel = (hits_l.depth - ref.depth).abs() / ref.depth
        close = float((rel[both] <= 1e-5).float().mean())
        other = both & ~same_face
        nearer = int((other & (hits_l.depth < ref.depth)).sum())
        agreement[name] = (hm, face, close)
        log(f"large mesh against the bunny's {name}: hit/miss agree "
            f"{hm:.6f}, face // {4 ** LEVELS} agrees on {face:.6f} of "
            f"{int(both.sum())} common hits, depth within 1e-5 relative on "
            f"{close:.6f} of them (max {float(rel[same_face].max()):.3g} "
            f"where the face agrees); {int(other.sum())} other faces, "
            f"{nearer} of them nearer on the large mesh")
    log(f"large mesh: {rc_l.num_triangles} triangles, {C_l} clusters of "
        f"{S_l}; level 0: the brute force and the resident cast agree on "
        f"{float((hits_bf.face_id == fid_0).float().mean()):.6f} of face ids")
    hm, face, close = agreement["brute force"]
    check(min(hm, face, close) >= LARGE_AGREE,
          "large mesh: the frame disagrees with the bunny's brute force")
    hm, face, close = agreement["resident cast"]
    check(hm >= LARGE_AGREE and face >= LARGE_FACE_AGREE,
          "large mesh: the frame disagrees with the bunny's resident cast")
    # the differentiable cast at 27M triangles: its hits are the caster's,
    # its depth the caster's refined depth, and the gradient reaches only
    # the triangles that were hit
    diff_same = prim_g == fid_l
    diff_agree = float(diff_same.float().mean())
    hd = diff_same & (fid_l >= 0)
    derr = float((depth_g[hd] - hits_l.depth[hd]).abs().max())
    gflat = grad_g.reshape(LARGE_TRIS, 9)
    touched = torch.zeros(LARGE_TRIS, dtype=torch.bool, device=dev)
    touched[prim_g[prim_g >= 0].long()] = True
    nz = gflat.abs().amax(dim=1) > 0
    log(f"cast_clusters_diff (27M triangles, clusters of 128): prim equals "
        f"the caster's face id on {diff_agree:.6f} of rays, depth max "
        f"difference {derr:.3g} where equal; gradient finite "
        f"{bool(torch.isfinite(gflat).all())}, on {int(nz.sum())} "
        f"triangles of {int(touched.sum())} hit")
    check(diff_agree >= LARGE_AGREE and derr <= 1e-5 * float(
        hits_l.depth[hd].max()), "cast_clusters_diff differs from the caster")
    check(bool(torch.isfinite(gflat).all()) and bool(nz.any())
          and not bool((nz & ~touched).any()),
          "cast_clusters_diff: gradient off the hit triangles")
    del grad_g, gflat, touched, nz

    # -- 4b. the training step is right --------------------------------------
    loss_v = loss_f.item()
    gnorm = float(grad_f.norm())
    check(np.isfinite(loss_v) and bool(torch.isfinite(grad_f).all())
          and gnorm > 0, f"flagship step: loss {loss_v}, |g| {gnorm}")
    with torch.no_grad():
        out = render_depth(sphere_dev, o_f, d_f, **step_kw)
    depth = out.depth.cpu().numpy().astype(np.float64)
    hit = out.hit.cpu().numpy()
    o64, d64 = (x.astype(np.float64) for x in (cam_f.origins, cam_f.dirs))
    for name, sph in (("unscaled r = 0.8 sphere", (np.zeros(3), 0.8)),
                      ("sphere the grid represents", grid_sphere())):
        a_hit, a_t = analytic_hits(o64, d64, *sph)
        agree = float(np.mean(hit == a_hit))
        both = hit & a_hit
        derr = np.abs(depth - a_t)[both]
        close = float(np.mean(derr <= 0.01))
        log(f"flagship step vs the {name}: hit/miss agree {agree:.6f}, "
            f"{close:.6f} of {int(both.sum())} common hits within 0.01 "
            f"(max {derr.max():.3g}); hit fraction {float(hit.mean()):.4f}")
    # held against the sphere the grid represents, the loop's last
    check(agree >= 0.999 and close >= 0.999,
          "flagship step disagrees with the analytic sphere")
    gaps = dict(loss=abs(loss_v / FLAGSHIP_R5["loss"] - 1),
                grad_norm=abs(gnorm / FLAGSHIP_R5["grad_norm"] - 1))
    log(f"flagship step: loss {loss_v!r} (FLAGSHIP_r5 "
        f"{FLAGSHIP_R5['loss']!r}, gap {gaps['loss']:.3e}), |g| {gnorm!r} "
        f"(FLAGSHIP_r5 {FLAGSHIP_R5['grad_norm']!r}, gap "
        f"{gaps['grad_norm']:.3e})")
    check(gaps["loss"] <= 0.01 and gaps["grad_norm"] <= 0.10,
          "flagship step: loss or |g| too far from FLAGSHIP_r5.json")

    # the training step on the small sphere: card against CPU, both tiers
    # of the cluster cast and the all-pairs backend
    small_kw = dict(vert_capacity=4096, face_capacity=8192, max_dist=10.0,
                    **BOX)
    target_s = np.full(cam_s.origins.shape[0], 1.7, np.float32)
    for backend, cap in (("pallas", 32_000), ("pallas", 0), ("mxu", None)):
        outs = []
        for device in ("cuda", "cpu"):
            ClusterRayCaster.MXU_MAX_TRIS = 32_000 if cap is None else cap
            dens = torch.from_numpy(g).to(device).requires_grad_()
            loss = sdf_fitting_loss(dens, cam_s.origins, cam_s.dirs,
                                    target_s, backend=backend,
                                    device=device, **small_kw)
            loss.backward()
            soup = marching_cubes_soup(dens.detach(), 0.0,
                                       face_capacity=8192, device=device,
                                       **BOX).soup
            _, fid = rk.cast_clusters_diff(
                soup, torch.from_numpy(cam_s.origins).to(device),
                torch.from_numpy(cam_s.dirs).to(device))
            outs.append((loss.item(), dens.grad.cpu(), fid.cpu()))
        ClusterRayCaster.MXU_MAX_TRIS = 32_000
        (lc, gc, fc), (lh, gh, fh) = outs
        check(torch.equal(fc, fh), f"small step {backend} {cap}: face ids")
        check(abs(lc - lh) <= 1e-6 * abs(lh),
              f"small step {backend} {cap}: loss {lc} vs {lh}")
        check(torch.allclose(gc, gh, rtol=1e-5,
                             atol=1e-6 * float(gh.abs().max())),
              f"small step {backend} {cap}: gradient differs")
    log("small sphere training step: card equals CPU (pallas at both "
        "tiers, mxu)")

    # a trainer that takes a few steps: examples/sdf_fitting.py's flagship
    # recipe, with Adam
    truth = torch.from_numpy(sphere_grid(r=0.8)).to(dev)
    init = torch.from_numpy(sphere_grid(r=0.6)).to(dev)
    nv, nf, na = (int(q) for q in _counts(truth, 0.0))

    def budget(q):  # 30% headroom, rounded up to 4096
        return -(-int(q * 1.3) // 4096) * 4096

    fit_kw = dict(vert_capacity=budget(nv), face_capacity=budget(nf),
                  active_capacity=budget(na), max_dist=10.0,
                  backend="pallas", **BOX)
    with torch.no_grad():
        target_t = render_depth(truth, o_f, d_f, **fit_kw).depth
    density = init.clone().requires_grad_()
    opt = torch.optim.Adam([density], lr=5e-3)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = sdf_fitting_loss(density, o_f, d_f, target_t, **fit_kw)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    log(f"Adam fitting, 3 steps (capacities {fit_kw['face_capacity']} "
        f"faces, {fit_kw['active_capacity']} active cubes): losses {losses}")
    check(all(np.isfinite(losses)) and losses[2] < losses[0],
          "the fitting loss did not go down")

    # -- 5. each kernel against its plain version at the path's shapes -----
    launches = {k: serving[k] + training[k] + large[k] + sharded[k]
                for k in serving}
    kernels = []

    cx, cy, cz, cm = mk.fused_masks(sphere_dev, 0.0)
    px, py, pz, pm = mk.fused_masks_plain(sphere_dev, 0.0)
    err = max(int((a.int() - b.int()).abs().max())
              for a, b in ((cx, px), (cy, py), (cz, pz), (cm, pm)))
    check(err == 0, "mc_masks differs from its plain version")
    ms = event_ms(lambda: mk.fused_masks(sphere_dev, 0.0), iters=20)
    dms, dsrc = device_ms(lambda: mk.fused_masks(sphere_dev, 0.0),
                          mk.KERNEL.name)
    pms = event_ms(lambda: mk.fused_masks_plain(sphere_dev, 0.0),
                   iters=5)
    mbytes = nbytes(sphere_dev, cx, cy, cz, cm)
    kernels.append(dict(
        name=mk.KERNEL.name, route="cuda",
        source="primitive3d_tpu_torch/csrc/mc_masks.cu",
        replaces=mk.KERNEL.replaces, launches=launches[mk.KERNEL.name],
        max_abs_err=float(err), ms=ms, device_ms=dms, device_ms_source=dsrc,
        plain_ms=pms, bound_ms=mbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None))
    # the other grid the paths launch it on: the bunny's 66^3 (4 of its 7
    # launches; the 256^3 sphere takes the other 3)
    bunny_dev = torch.from_numpy(bunny).to(dev)
    bx, by, bz, bm = mk.fused_masks(bunny_dev, 0.0)
    check(all(torch.equal(a, b) for a, b in zip(
        (bx, by, bz, bm), mk.fused_masks_plain(bunny_dev, 0.0))),
        "mc_masks differs from its plain version at 66^3")
    ms66 = event_ms(lambda: mk.fused_masks(bunny_dev, 0.0), iters=20)
    dms66, dsrc66 = device_ms(lambda: mk.fused_masks(bunny_dev, 0.0),
                              mk.KERNEL.name)
    b66 = nbytes(bunny_dev, bx, by, bz, bm) / HBM_BYTES_PER_S * 1e3
    # edge shapes: two launches equal to the plain version
    rng = np.random.default_rng(8)
    for shape in MASK_EDGE_SHAPES:
        g_e = rng.standard_normal(shape).astype(np.float32)
        flat = g_e.reshape(-1)
        flat[::7], flat[3::11], flat[5::13], flat[2::17] = (
            0.0, np.inf, -np.inf, np.nan)
        g_e = torch.from_numpy(g_e).to(dev)
        want = mk.fused_masks_plain(g_e, 0.0)
        for _ in range(2):
            check(all(torch.equal(a, b) for a, b in zip(
                mk.fused_masks(g_e, 0.0), want)),
                f"mc_masks differs from its plain version at {shape}")
    log(f"mc_masks 256^3: exact; {ms:.4f} ms per call, device {dms:.4f} ms "
        f"({dsrc}) (plain {pms:.3f} ms), bound "
        f"{mbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; 66^3: exact; "
        f"{ms66:.4f} ms per call, device {dms66:.4f} ms ({dsrc66}), bound "
        f"{b66:.5f} ms; exact over two launches at "
        f"{', '.join(str(x) for x in MASK_EDGE_SHAPES)} (values at the "
        f"threshold, +-inf, NaN)")

    def same_lists(got, want):
        """Bit equality of two (n, work, bounds) lists."""
        return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and ((got[2] is None and want[2] is None)
                     or torch.equal(got[2].view(torch.int32),
                                    want[2].view(torch.int32))))

    def exact_cast(name, got, want, lists=None):
        """Depth (bits), index and finish rows equal on every ray; print the
        rays that differ and fail. With ``lists`` = (n, work, stream, w,
        rays, max_dist, edge_wildcard) (the cluster casts, whose culls skip
        visits), a differing ray passes only where the float64 witness of
        rk.cast_disputes settles it: the plain version's nearer hit is
        float32 noise, and the kernel kept the nearest hit that is not.
        Returns the rays settled."""
        dk, ik, fk = got
        dp, ip, fp = want
        fin_bad = ((fk.view(torch.int32) != fp.view(torch.int32)).any(dim=1)
                   if fk is not None else torch.zeros_like(ik, dtype=bool))
        bad = ((dk.view(torch.int32) != dp.view(torch.int32)) | (ik != ip))
        check(not bool((fin_bad & ~bad).any()), f"{name}: finish rows differ "
              f"where depth and index agree")
        if lists is None:
            qs = bad.nonzero()[:, 0]
            settled = torch.zeros_like(qs, dtype=torch.bool)
            clean = dk[qs]
        else:
            qs, settled, clean = rk.cast_disputes(*lists, got, want)
        for j, q in enumerate(qs[:20].tolist()):
            log(f"  {name} ray {q}: kernel ({float(dk[q])!r}, {int(ik[q])}), "
                f"plain ({float(dp[q])!r}, {int(ip[q])}), nearest hit that "
                f"is not noise {float(clean[j])!r}; settled by the float64 "
                f"witness: {bool(settled[j])}")
        nbad = int((~settled).sum())
        check(nbad == 0, f"{name}: differs from the plain version on {nbad} "
              f"of {dk.shape[0]} rays")
        return int(qs.shape[0])

    stage = {}
    cull_rows = {}
    for name, rc, cam, kern, fn in (
            ("bunny", rc_b, cam_b, rk.RESIDENT, rk.cluster_cast_resident),
            ("flagship", rc_f, cam_f, rk.STREAM, rk.cluster_cast_stream)):
        o = torch.from_numpy(cam.origins).to(dev)
        d = torch.from_numpy(cam.dirs).to(dev)
        R = o.shape[0]
        pad = (-R) % rk.MBLOCK
        op = torch.cat([o, torch.zeros((pad, 3), device=dev)])
        dp = torch.cat([d, torch.ones((pad, 3), device=dev)])
        bvh = rc.cbvh
        n, work, bounds, rays = rk._mxu_prep(bvh, op, dp, rc.max_dist,
                                             rc.stream)
        # the work-list cull against its plain version, bit for bit: both
        # tiers on the bunny, the stream tier on the flagship
        for stream in ((False, True) if name == "bunny" else (True,)):
            got = rk.work_lists(bvh.boxes, rays, rc.max_dist, stream)
            want = rk.work_lists_plain(bvh.boxes, rays, rc.max_dist, stream)
            check(same_lists(got, want), f"stream_cull ({name}, "
                  f"{'stream' if stream else 'resident'} tier) differs from "
                  f"its plain version")
            if stream == rc.stream:
                check(same_lists((n, work, bounds), got),
                      f"stream_cull ({name}): the path's lists differ")
        C = bvh.num_clusters
        B = n.shape[0]
        cms = event_ms(lambda: rk.work_lists(bvh.boxes, rays, rc.max_dist,
                                             rc.stream), iters=20)
        cdms, cdsrc = device_ms(lambda: rk.work_lists(
            bvh.boxes, rays, rc.max_dist, rc.stream), rk.CULL.name)
        cpms = event_ms(lambda: rk.work_lists_plain(
            bvh.boxes, rays, rc.max_dist, rc.stream), iters=3, warmup=1)
        # the cull's bound: the rays' origins and directions read once, the
        # boxes, the lists written once; every (chunk, cluster) cell's slab
        # test, the intervals (two compares per value, one division per
        # direction) and, stream tier, n log2 n comparisons to sort a row
        nb = n.double()
        sort_ops = (float((nb * torch.log2(nb.clamp(min=2))).sum())
                    if rc.stream else 0.0)
        c_ops = (B * rk.NCH * C * CULL_OPS_PER_CELL + B * rk.MBLOCK * 15
                 + sort_ops)
        c_bytes = (B * rk.MBLOCK * 6 * 4 + nbytes(bvh.boxes, n, work, bounds))
        ct_ops = c_ops / FP32_FLOP_PER_S * 1e3
        ct_bytes = c_bytes / HBM_BYTES_PER_S * 1e3
        cull_rows[name] = dict(
            name=rk.CULL.name, route="cuda",
            source="primitive3d_tpu_torch/csrc/stream_cull.cu",
            replaces=rk.CULL.replaces, launches=launches[rk.CULL.name],
            max_abs_err=0.0, ms=cms, device_ms=cdms, device_ms_source=cdsrc,
            plain_ms=cpms, bound_ms=max(ct_ops, ct_bytes),
            bound_by="operations" if ct_ops >= ct_bytes else "bytes",
            library_ms=None)
        log(f"stream_cull ({name}, {'stream' if rc.stream else 'resident'} "
            f"tier): lists equal the plain version's bit for bit; {cms:.4f} "
            f"ms per call, device {cdms:.4f} ms ({cdsrc}) (plain {cpms:.3f} "
            f"ms); {B} blocks x {C} clusters, "
            f"{int(n.sum())} list entries, bound {max(ct_ops, ct_bytes):.4f} "
            f"ms (operations {ct_ops:.4f}, bytes {ct_bytes:.4f})")

        args = (n, work) + ((bounds,) if rc.stream else ()) + (
            bvh.w, bvh.fin, rays, rc.max_dist)
        kw = dict(boxes=bvh.boxes, sub_boxes=bvh.sub_boxes)
        visits = torch.zeros((B * rk.NCH, 3), dtype=torch.int32, device=dev)
        dk, ik, fk = fn(*args, visits=visits, **kw)
        dpl, ipl, fpl = rk.cluster_cast_plain(n, work, bounds, bvh.w,
                                              bvh.fin, rays, rc.max_dist)
        nset = exact_cast(f"{kern.name} ({name})", (dk, ik, fk),
                          (dpl, ipl, fpl),
                          (n, work, rc.stream, bvh.w, rays, rc.max_dist,
                           False))
        err = float((dk - dpl).abs().max())
        # (cluster, chunk) visits in the work list: what the plain version
        # does, and what the stream kernel would do without its early exit
        live = torch.arange(work.shape[1], device=dev)[None, :] < n[:, None]
        if rc.stream:
            bits = (work[:, :, None] >> torch.arange(rk.NCH, device=dev)) & 1
            flagged = int(bits.sum(dim=-1)[live].sum())
        else:
            flagged = int(n.sum())
        S = bvh.cluster_size
        ms = event_ms(lambda: fn(*args, **kw))
        dms, dsrc = device_ms(lambda: fn(*args, **kw), kern.name)
        pms = event_ms(lambda: rk.cluster_cast_plain(
            n, work, bounds, bvh.w, bvh.fin, rays, rc.max_dist),
            iters=3, warmup=1)
        # the bound: the work the frame's result says any walk of the
        # cluster boxes and their sub-boxes needs, whatever its design
        # (needed_work, the scalar tier's rule: every box a ray enters is
        # listed for its chunk, the lists being conservative); the kernel's
        # own visits give a second, per-visit figure
        per = S // bvh.sub_boxes.shape[1]
        slabs_c, tris_c, used_c, used_s = needed_work(
            rk, bvh, o, d, dk[:R], ik[:R] >= 0, rc.max_dist)
        tris_c = tris_c // rk.SUB_SIZE * per
        ops = slabs_c * SLAB_OPS + tris_c * CAST_OPS_PER_TEST
        cbytes = (R * (9 * 4 + 4 + 4 + 8 * 4) + (used_c + used_s) * 6 * 4
                  + used_s * per * rk.WROW * 4)
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        t_bytes = cbytes / HBM_BYTES_PER_S * 1e3
        reached, tested, subs = (int(x) for x in visits.sum(dim=0))
        tris = subs * per
        visit_ops = tris * rk.STREAM_WALK * CAST_OPS_PER_TEST
        kernels.append(dict(
            name=kern.name, route="cuda",
            source="primitive3d_tpu_torch/csrc/cluster_cast.cu",
            replaces=kern.replaces, launches=launches[kern.name],
            max_abs_err=err, ms=ms, device_ms=dms, device_ms_source=dsrc,
            plain_ms=pms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
        units = B * rk.NCH * (rk.RCHUNK // rk.STREAM_WALK)
        log(f"{kern.name} ({name}): depth, index and finish rows equal the "
            f"plain version's on all {rays.shape[1]} rays but {nset} settled "
            f"by the float64 witness; {ms:.3f} ms per call, device "
            f"{dms:.4f} ms ({dsrc}) (plain {pms:.2f} ms); {B} blocks, "
            f"{int(n.sum())} list "
            f"entries, {flagged} (chunk, cluster) visits listed; the "
            f"kernel's warps reached {reached} listed visits "
            f"({reached / units:.2f} per warp) and tested {tested} "
            f"({tested / units:.2f}) after the box cull, and {tris} "
            f"triangles ({tris / units:.1f}) after the sub-box cull; bound "
            f"{max(t_ops, t_bytes):.4f} ms from the frame's needed work: "
            f"{slabs_c} slab tests of the boxes and sub-boxes entered nearer "
            f"than the final depth ({slabs_c / R:.2f} per ray) and {tris_c} "
            f"triangle tests ({tris_c / R:.2f} per ray), {used_c} clusters "
            f"and {used_s} sub-boxes entered by some ray "
            f"(operations {t_ops:.4f} ms, bytes {t_bytes:.4f} ms); the "
            f"kernel's tested triangles x {rk.STREAM_WALK} lanes would bound "
            f"it at "
            f"{visit_ops / FP32_FLOP_PER_S * 1e3:.4f} ms")

        # -- 6. the path's stage times for this configuration --------------
        grid = bunny if name == "bunny" else sphere_dev
        scale = 1.0 if name == "bunny" else (-1.0, 1.0)
        v, f = (v_b, f_b) if name == "bunny" else (v_f, f_f)
        t_mc = event_ms(lambda: marching_cubes(grid, 0.0, scale=scale),
                        iters=5)
        t_build = event_ms(lambda: create_raycaster(
            v, f, backend="pallas"), iters=5)
        t_prep = event_ms(lambda: rk._mxu_prep(
            bvh, op, dp, rc.max_dist, rc.stream), iters=5)
        t_cast = event_ms(lambda: rc.cast(o, d), iters=10)
        stage[name] = dict(mc_ms=t_mc, build_ms=t_build, prep_ms=t_prep,
                           cull_ms=cms, kernel_ms=ms, cast_ms=t_cast,
                           mrays_per_s=R / (t_cast * 1e3), rays=R)
        log(f"path {name}: MC {t_mc:.3f} ms, cluster build {t_build:.3f} "
            f"ms, prep {t_prep:.3f} ms (the cull kernel {cms:.4f} of it), "
            f"kernel {ms:.3f} ms, cast {t_cast:.3f} ms = "
            f"{R / (t_cast * 1e3):.2f} Mrays/s")
    kernels.append(cull_rows["flagship"])

    # the stream cast on the flagship step's own inputs: 3,328
    # identity-order clusters of the soup, whose padding rows are point
    # triangles; the winners' fin rows are the forward depth's planes
    sargs, skw = stream_args[0]
    n_t, e_t, b_t = sargs[:3]
    check(same_lists((n_t, e_t, b_t), rk.work_lists_plain(
        skw["boxes"], sargs[5], sargs[6], True)),
        "stream_cull (training): the step's lists differ from the plain "
        "version's")
    got = rk.cluster_cast_stream(*sargs, **skw)
    nset = exact_cast(f"{rk.STREAM.name} (training)", got,
                      rk.cluster_cast_plain(*sargs),
                      (n_t, e_t, True, sargs[3], sargs[5], sargs[6],
                       sargs[7]))
    log(f"{rk.STREAM.name} (training step's inputs): {n_t.shape[0]} "
        f"blocks, {sargs[3].shape[0]} clusters; the lists equal the plain "
        f"cull's and depth, index and finish rows equal the plain cast's on "
        f"all {sargs[5].shape[1]} rays"
        f"{f' but the {nset} settled above' if nset else ''}")

    # the plane scatter on the flagship backward's own inputs
    args = scatter_args[0]
    gp, wp, n4, e4, C4, S4 = args
    k1 = rk.plane_scatter(*args)
    k2 = rk.plane_scatter(*args)
    p4 = rk.plane_scatter_plain(*args)
    check(torch.equal(k1, k2), "plane_scatter: two launches differ")
    err = float((k1 - p4).abs().max())
    rel = err / float(p4.abs().max())
    check(rel <= 1e-5, f"plane_scatter: relative error {rel}")
    widx64 = wp.clamp(min=0).to(torch.int64)

    def library():  # the one PyTorch call of the same function
        return torch.zeros((C4 * S4, 4), device=dev).index_add_(0, widx64, gp)

    check(torch.allclose(library(), p4, rtol=1e-4,
                         atol=1e-6 * float(p4.abs().max())),
          "index_add_ differs from the plain plane scatter")
    ms = event_ms(lambda: rk.plane_scatter(*args), iters=20)
    dms, dsrc = device_ms(lambda: rk.plane_scatter(*args),
                          rk.PLANE_SCATTER.name)
    # each pass alone, on the scratch of a full launch: the keys (sort per
    # block, bitmap) and the sums; the full time holds the allocations too
    scratch = rk._scatter_scratch(n4.shape[0], C4, dev)
    outp = torch.empty_like(k1)
    rk._plane_scatter_passes(*args, outp, scratch, 3)
    check(torch.equal(outp, k1), "plane_scatter: the passes differ from the "
          "wrapper")
    pass_ms = [event_ms(lambda: rk._plane_scatter_passes(
        *args, outp, scratch, p), iters=20) for p in (1, 2)]
    check(torch.equal(outp, k1), "plane_scatter: a timed pass changed the "
          "output")
    pms = event_ms(lambda: rk.plane_scatter_plain(*args), iters=5)
    lms = event_ms(library, iters=20)
    B4 = n4.shape[0]
    hit_rays = int((wp >= 0).sum())
    # what the function needs: every winner index, the cotangent rows of
    # the rays with a winner, the live words of the list, and the output
    sbytes = (nbytes(wp, k1) + hit_rays * 4 * gp.element_size()
              + int(n4.sum()) * e4.element_size())
    kernels.append(dict(
        name=rk.PLANE_SCATTER.name, route="cuda",
        source="primitive3d_tpu_torch/csrc/plane_scatter.cu",
        replaces=rk.PLANE_SCATTER.replaces,
        launches=launches[rk.PLANE_SCATTER.name], max_abs_err=err, ms=ms,
        device_ms=dms, device_ms_source=dsrc, plain_ms=pms, bound_ms=sbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=lms))
    log(f"plane_scatter passes (flagship backward): keys (the list table, "
        f"a sort per 2048-ray block, the bitmap's zero fill) "
        f"{pass_ms[0]:.4f} ms, sums {pass_ms[1]:.4f} ms")
    log(f"plane_scatter (flagship backward): equal bits over two launches, "
        f"max err {err:.3g} (relative {rel:.3g}); {ms:.4f} ms, the scratch "
        f"and both passes, device {dms:.4f} ms ({dsrc}; the bitmap's memset "
        f"and both passes) (plain {pms:.3f} ms, index_add_ {lms:.4f} ms); "
        f"{C4} clusters x {B4} blocks, {hit_rays} rays with a winner, "
        f"{int(n4.sum())} list entries, bound "
        f"{sbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")

    # the scalar-tier kernels on the large path's inputs: the whole frame on
    # the card, each kernel held bit for bit against the plain version on
    # every ray of the frame
    bvh_l, tree_l = rc_l.cbvh, rc_l.tree
    R_b = o_b.shape[0]
    rays_l = torch.cat([o_b, d_b], dim=1).T.contiguous()
    nsub = S_l // rk.SUB_SIZE
    log(f"large mesh tree: {' -> '.join(str(n) for n in tree_l.sizes)} "
        f"nodes per level, {nbytes(tree_l.nodes)} bytes")
    scalar = {}
    for kern, ordered in ((rk.SCALAR_ORDERED, True), (rk.SCALAR, False)):
        fn = rk.cluster_scalar_ordered if ordered else rk.cluster_scalar
        counts = torch.zeros((R_b, 4), dtype=torch.int32, device=dev)
        dk, ik = fn(tree_l, bvh_l, rays_l, rc_l.max_dist, counts=counts)
        ms = event_ms(lambda: fn(tree_l, bvh_l, rays_l, rc_l.max_dist),
                      iters=10, warmup=2)
        dms = device_ms(lambda: fn(tree_l, bvh_l, rays_l, rc_l.max_dist),
                        kern.name, calls=10)
        scalar[ordered] = (dk, ik, ms, counts.to(torch.int64), dms)

    # one bound for both rows, the same function: the work that the frame's
    # result says any walk of the cluster boxes and sub-boxes must do,
    # counted per ray
    dk_o, ik_o = scalar[True][0], scalar[True][1]
    slabs_n, tris_n, boxes_n, subs_n = needed_work(
        rk, bvh_l, o_b, d_b, dk_o, ik_o >= 0, rc_l.max_dist)
    ops_n = slabs_n * SLAB_OPS + tris_n * TRI_OPS
    bytes_n = (nbytes(o_b, d_b, dk_o, ik_o) + (boxes_n + subs_n) * 24
               + subs_n * rk.SUB_SIZE * 36)
    t_ops = ops_n / FP32_FLOP_PER_S * 1e3
    t_bytes = bytes_n / HBM_BYTES_PER_S * 1e3
    bound_l = max(t_ops, t_bytes)
    log(f"scalar kernels' bound (large frame, {R_b} rays): {slabs_n} slab "
        f"tests ({slabs_n / R_b:.1f} per ray) and {tris_n} triangle tests "
        f"({tris_n / R_b:.1f} per ray) the frame's depth needs, {ops_n:.4g} "
        f"operations, {boxes_n} cluster boxes and {subs_n} sub-boxes entered "
        f"by some ray, {bytes_n} bytes; bound {bound_l:.4f} ms (operations "
        f"{t_ops:.4f}, bytes {t_bytes:.4f})")
    hit_o = ik_o >= 0
    for kern, ordered in ((rk.SCALAR_ORDERED, True), (rk.SCALAR, False)):
        dk, ik, ms, c64, (dms, dsrc) = scalar[ordered]
        full = torch.zeros((R_b, 4), dtype=torch.int32, device=dev)
        ta = torch.cuda.Event(enable_timing=True)
        tb = torch.cuda.Event(enable_timing=True)
        ta.record()
        dpl, ipl = rk.cluster_scalar_plain(tree_l, bvh_l, rays_l,
                                           rc_l.max_dist, ordered, full)
        tb.record()
        torch.cuda.synchronize()
        pms = ta.elapsed_time(tb)
        d_eq = dk.view(torch.int32) == dpl.view(torch.int32)
        i_eq = ik == ipl
        log(f"{kern.name}: {R_b} rays compared with the plain version, depth "
            f"bit-equal on {int(d_eq.sum())}, ids on {int(i_eq.sum())}")
        check(bool(d_eq.all()) and bool(i_eq.all()),
              f"{kern.name}: differs from its plain version on "
              f"{int((~(d_eq & i_eq)).sum())} rays")
        err = float((dk - dpl).abs().max())
        f64 = full.to(torch.int64)
        check(bool((c64 <= f64).all()),
              f"{kern.name}: walks more than the walk without pruning")
        nodes, boxes, subs, tris = (int(x) for x in c64.sum(dim=0))
        slabs = boxes + subs
        per = {name: [float(x) for x in c64[sel].double().mean(dim=0)]
               for name, sel in (("hit", hit_o), ("missing", ~hit_o))}
        fslabs = int(f64[:, 1].sum() + f64[:, 2].sum())
        kernels.append(dict(
            name=kern.name, route="cuda",
            source="primitive3d_tpu_torch/csrc/cluster_scalar.cu",
            replaces=kern.replaces, launches=launches[kern.name],
            max_abs_err=err, ms=ms, device_ms=dms, device_ms_source=dsrc,
            plain_ms=pms, plain_rays=R_b, bound_ms=bound_l,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
        log(f"{kern.name} (large mesh, {R_b} rays, {C_l} clusters of "
            f"{S_l}): equals its plain version bit for bit on all {R_b} "
            f"rays; {ms:.3f} ms per call, device {dms:.4f} ms ({dsrc}) "
            f"(plain, whole frame, {pms:.1f} ms); walk: "
            f"{nodes} nodes entered, {boxes} child box, {subs} sub-box and "
            f"{tris} triangle tests; per hit ray [nodes, boxes, sub-boxes, "
            f"triangles] {[round(x, 2) for x in per['hit']]}, per missing "
            f"ray {[round(x, 2) for x in per['missing']]}; "
            f"{slabs / slabs_n:.2f}x the needed slab tests and "
            f"{tris / tris_n:.2f}x the needed triangle tests (the walk "
            f"without pruning: {fslabs / slabs_n:.2f}x and "
            f"{int(f64[:, 3].sum()) / tris_n:.2f}x); {ms / bound_l:.1f}x the "
            f"bound")
    (dk_o, ik_o, ms_o, _, _), (dk_u, ik_u, ms_u, _, _) = (
        scalar[True], scalar[False])

    # the rays on which the large frame disagrees with a level-0 yardstick:
    # the 27M mesh itself brute-forced on them, every triangle row in sorted
    # space with the kernels' arithmetic; the frame must equal it
    lvl = fid_l // 4 ** LEVELS
    disputed = ((lvl != fid_0) | (lvl != hits_bf.face_id)).nonzero()[:, 0]
    tri_flat = bvh_l.tri_data.view(-1, 9)

    def brute(rays_x):
        o_x, d_x = o_b[rays_x], d_b[rays_x]
        bt, bi = brute_force_sorted(rk, tri_flat, o_x, d_x, rc_l.max_dist)
        return o_x, d_x, bt, bi

    o_x, d_x, bt, bi = brute(disputed)
    kd, ki = dk_o[disputed], ik_o[disputed].to(torch.int64)
    kt = rk._triangle_t(tri_flat[ki.clamp(min=0)][:, None],
                        [o_x[:, q].reshape(-1, 1, 1) for q in range(3)],
                        [d_x[:, q].reshape(-1, 1, 1) for q in range(3)]
                        ).reshape(-1)
    hit_x = bi >= 0
    same_id = int((ki == bi).sum())
    ties = int(((ki != bi) & hit_x & (kt == bt)).sum())
    log(f"large mesh, the {disputed.shape[0]} rays where it disagrees with "
        f"the level-0 resident cast or brute force, brute-forced over all "
        f"{tri_flat.shape[0]} triangle rows: depth bit-equal "
        f"{torch.equal(kd, bt)}, hit/miss equal "
        f"{torch.equal(ki >= 0, hit_x)}, {int(hit_x.sum())} hits, the same "
        f"triangle on {same_id} rays and an exact depth tie on {ties}")
    check(torch.equal(kd, bt) and torch.equal(ki >= 0, hit_x)
          and same_id + ties == disputed.shape[0],
          "large mesh: the frame differs from the brute force of the 27M "
          "mesh on the disputed rays")
    # the two kernels compute one function but for the sub-box cull: every
    # ray where they differ must be one where the unordered kernel's result
    # is the brute force's and the ordered kernel's sub-box cull dropped it
    uo = ((dk_u.view(torch.int32) != dk_o.view(torch.int32))
          | (ik_u != ik_o)).nonzero()[:, 0]
    settled = True
    if uo.numel():
        _, _, bt, bi = brute(uo)
        settled = (torch.equal(dk_u[uo], bt)
                   and torch.equal(ik_u[uo].to(torch.int64), bi)
                   and bool((dk_o[uo] >= bt).all()))
        for j, q in enumerate(uo[:20].tolist()):
            log(f"  ray {q}: ordered ({float(dk_o[q])!r}, {int(ik_o[q])}), "
                f"unordered ({float(dk_u[q])!r}, {int(ik_u[q])}), brute "
                f"force ({float(bt[j])!r}, {int(bi[j])})")
    log(f"unordered vs ordered kernel, whole frame: bit-equal in depth and "
        f"id on {R_b - uo.shape[0]} of {R_b} rays; the {uo.shape[0]} others "
        f"settled by the brute force in the unordered kernel's favour: "
        f"{settled}; the path's cast_clusters(ordered=False) equals the "
        f"kernel: {torch.equal(t_u, dk_u) and torch.equal(i_u, ik_u)}")
    check(settled, "the unordered kernel disagrees with the ordered one "
          "beyond the sub-box cull")
    check(torch.equal(t_u, dk_u) and torch.equal(i_u, ik_u),
          "cast_clusters(ordered=False) differs from its kernel")
    del tri_flat, bt, bi, kd, ki, kt

    # the large path's stages: the caster's build (clusters and tree), the
    # tree alone, the kernel, and the rest of the cast (ray rows and the
    # finish); no per-block order and bounds on this path any more
    t_build = event_ms(lambda: create_raycaster(v_l, f_l, backend="pallas"),
                       iters=2, warmup=0)
    t_tree = event_ms(lambda: build_cluster_tree(bvh_l.boxes), iters=10)
    t_cast = event_ms(lambda: rc_l.cast(o_b, d_b), iters=10, warmup=2)
    stage["large"] = dict(build_ms=t_build, tree_ms=t_tree, kernel_ms=ms_o,
                          finish_ms=t_cast - ms_o, cast_ms=t_cast,
                          unordered_kernel_ms=ms_u,
                          mrays_per_s=R_b / (t_cast * 1e3), rays=R_b,
                          triangles=LARGE_TRIS)
    log(f"path large mesh: cluster build {t_build:.3f} ms (the tree "
        f"included: {t_tree:.3f} ms), kernel {ms_o:.3f} ms, finish "
        f"{t_cast - ms_o:.3f} ms, cast {t_cast:.3f} ms = "
        f"{R_b / (t_cast * 1e3):.3f} Mrays/s (no order-and-bounds stage: "
        f"the walk needs none)")
    del v_l, f_l, rc_l, bvh_l, tree_l, scalar, dk_o, dk_u, ik_o, ik_u

    # the other backends on the bunny against the cluster caster
    for backend in ("mxu", "bruteforce", "bvh"):
        ta = torch.cuda.Event(enable_timing=True)
        tb = torch.cuda.Event(enable_timing=True)
        tc = torch.cuda.Event(enable_timing=True)
        ta.record()
        rc_x = create_raycaster(v_b, f_b, backend=backend)
        tb.record()
        hx = rc_x.cast(cam_b.origins, cam_b.dirs)
        tc.record()
        torch.cuda.synchronize()
        same = hx.face_id == fid_0
        agree = float(same.float().mean())
        hm = float(((hx.face_id >= 0) == (fid_0 >= 0)).float().mean())
        ok = torch.allclose(hx.depth[same], hits_b.depth[same], rtol=1e-5,
                            atol=1e-6)
        log(f"backend {backend} on the bunny: build {ta.elapsed_time(tb):.3f}"
            f" ms, cast {tb.elapsed_time(tc):.3f} ms; face ids equal the "
            f"cluster caster's on {agree:.6f} of rays, hit/miss on {hm:.6f}, "
            f"depth allclose where equal: {ok}")
        check(agree >= LARGE_AGREE and ok,
              f"backend {backend} disagrees with the cluster caster")
        stage[f"bunny_{backend}"] = dict(build_ms=ta.elapsed_time(tb),
                                         cast_ms=tb.elapsed_time(tc))
        del rc_x, hx

    # -- 6b. the training path's stage times ----------------------------------
    dens_t = sphere_dev.clone().requires_grad_()

    def step():
        dens_t.grad = None
        loss = sdf_fitting_loss(dens_t, o_f, d_f, target_f, **step_kw)
        loss.backward()

    t_soup = event_ms(lambda: marching_cubes_soup(
        sphere_dev, 0.0, face_capacity=FLAGSHIP_FC, **BOX), iters=5)
    t_fwd = event_ms(lambda: render_depth(dens_t, o_f, d_f, **step_kw),
                     iters=5)
    t_bwd = backward_ms(lambda: sdf_fitting_loss(
        dens_t, o_f, d_f, target_f, **step_kw))
    t_step = event_ms(step, iters=5)
    stage["training"] = dict(soup_mc_ms=t_soup, forward_ms=t_fwd,
                             backward_ms=t_bwd, step_ms=t_step,
                             mrays_per_s=R_f / (t_step * 1e3), rays=R_f,
                             loss=loss_v, grad_norm=gnorm)
    log(f"path training (flagship step): soup MC {t_soup:.3f} ms, "
        f"render_depth forward {t_fwd:.3f} ms, backward {t_bwd:.3f} ms, "
        f"step {t_step:.3f} ms = {R_f / (t_step * 1e3):.2f} Mrays/s")
    stage["training"].update(profile_step(
        step, groups=dict(corner_adds="indexFunc")))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    del dens_t

    # -- 6c. the soup backward's corner adds on the step's own cotangent:
    # the padding rows in a tail past the grid, against the old layout
    # built here, every padding row added at cube 0 (equal after + 0.0,
    # which folds signed zeros)
    idx_c, valid_c, g_c, shape_c = corner_args[0]

    def old_adds():
        dflat = g_c.new_zeros(shape_c.numel())
        for c in range(8):
            dflat.index_add_(0, idx_c[:, c], g_c[:, c])
        return dflat.reshape(shape_c)

    def new_adds():
        return mcmod._corner_adds(idx_c, valid_c, g_c, shape_c)

    new_g, old_g = new_adds(), old_adds()
    check(torch.equal(new_g, grad_f), "corner adds: not the step's "
          "gradient")
    check(torch.equal(new_g + 0.0, old_g + 0.0), "corner adds: the "
          "gradient differs from the old layout's")
    A_c = idx_c.shape[0]
    pad_c = int((~valid_c).sum())
    at = mcmod._corner_index(idx_c, valid_c, shape_c.numel())
    check(all(at[:, c].unique().numel() == A_c for c in range(8)),
          "corner adds: a column of the add index repeats an index")
    corner = dict(rows=A_c, padding_rows=pad_c,
                  old_rows_at_one_index=int((idx_c[:, 0] == idx_c[-1, 0])
                                            .sum()),
                  bit_equal=torch.equal(new_g, old_g))
    for name, fn in (("new", new_adds), ("old", old_adds)):
        corner[f"{name}_ms"] = event_ms(fn, iters=20)
        corner[f"{name}_device_ms"], corner[f"{name}_device_src"] = \
            device_ms(fn, None)
    # the bytes the adds need: each index and cotangent read once, the grid
    # written once
    corner["bound_ms"] = (nbytes(idx_c, g_c) + shape_c.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    stage["corner_adds"] = corner
    log(f"soup backward's corner adds (flagship step's cotangent, {A_c} "
        f"rows, {pad_c} of them padding; the old layout put "
        f"{corner['old_rows_at_one_index']} rows of a column at one "
        f"index): equal to the old layout after + 0.0, bit-equal "
        f"{corner['bit_equal']}; each column injective; device "
        f"{corner['new_device_ms']:.4f} ms ({corner['new_device_src']}) "
        f"against the old layout's {corner['old_device_ms']:.4f} ms "
        f"({corner['old_device_src']}), per call {corner['new_ms']:.4f} "
        f"against {corner['old_ms']:.4f} ms; bound "
        f"{corner['bound_ms']:.4f} ms (bytes)")
    del idx_c, valid_c, g_c, new_g, old_g, at, corner_args

    # -- 6d. the backwards whose misses or padding rows all added into one
    # index, each on its path's own cotangent at full size: the dropped rows
    # sent to a tail past the output, against the old layout built here
    from primitive3d_tpu_torch.mxu_cast import triangle_matrix

    padded = {}
    gen = torch.Generator(device=dev).manual_seed(13)

    # F1: the bunny's soup in the resident tier, under its 512x512 rays
    tris_b = v_b[f_b.long()].clone().requires_grad_()

    def bunny_diff():
        depth, prim = rk.cast_clusters_diff(tris_b, o_b, d_b)
        check(tris_b.shape[0] <= ClusterRayCaster.MXU_MAX_TRIS,
              "the bunny's cast is not in the resident tier")
        torch.where(prim >= 0, depth, 0.0).sum().backward()

    _, (f1,) = recorded(rk, bunny_diff)
    padded["resident_planes"] = padded_backward(
        "resident_planes (cast_clusters_diff, bunny, 512x512)", f1,
        old_planes_select, mcmod)
    # F2: the large mesh's scalar-tier backward, recorded on its path
    padded["scalar_planes"] = padded_backward(
        f"scalar_planes (cast_clusters_diff, {LARGE_TRIS} triangles)",
        tail_args[0], old_index_backward, mcmod)
    # F3: the 256^3 sphere's indexed mesh at the fitting budgets, a seeded
    # cotangent on its vertices
    caps = dict(vert_capacity=fit_kw["vert_capacity"],
                face_capacity=fit_kw["face_capacity"],
                active_capacity=fit_kw["active_capacity"], **BOX)
    dens_p = sphere_dev.clone().requires_grad_()
    res_p = marching_cubes_padded(dens_p, 0.0, **caps)
    ct_v = torch.randn(res_p.vertices.shape, generator=gen, device=dev)
    _, (f3,) = recorded(mcmod, lambda: res_p.vertices.backward(ct_v))
    check(torch.allclose(mcmod._tail_adds(*f3).reshape(dens_p.shape),
                         dens_p.grad, rtol=0,
                         atol=1e-5 * float(dens_p.grad.abs().max())),
          "mesh_density: not the path's gradient")
    padded["mesh_density"] = padded_backward(
        "mesh_density (marching_cubes_padded, 256^3)", f3,
        old_index_backward, mcmod)
    # F4: render_depth's "mxu" de-index of that mesh; the cotangent comes
    # back through triangle_matrix, which zeroes the padded faces' rows
    verts_p = res_p.vertices.detach().requires_grad_()
    Fc = res_p.faces.shape[0]
    ct_w = torch.randn((Fc, 10, 5), generator=gen, device=dev)

    def deindex():
        tris = mcmod._TailGather.apply(
            verts_p, res_p.faces.long(),
            torch.arange(Fc, device=dev) < res_p.num_faces)
        triangle_matrix(tris).backward(ct_w)

    _, (f4,) = recorded(mcmod, deindex)
    padded["deindex_vertices"] = padded_backward(
        f"deindex_vertices (render_depth mxu, {Fc} faces)", f4,
        old_index_backward, mcmod)
    del tris_b, f1, dens_p, res_p, ct_v, f3, verts_p, ct_w, f4, tail_args

    # the small sphere's "mxu" training step as a whole, both layouts; its
    # device time sums every kernel of a step
    g_small = torch.from_numpy(g).to(dev)

    def small_mxu_step():
        dens = g_small.clone().requires_grad_()
        sdf_fitting_loss(dens, cam_s.origins, cam_s.dirs, target_s,
                         backend="mxu", **small_kw).backward()

    step = {}
    for key in ("new", "old", "new2", "old2"):
        if key.startswith("old"):
            mcmod._tail_adds = old_index_backward
        try:
            step[f"{key}_ms"] = event_ms(small_mxu_step, iters=5)
            step[f"{key}_device_ms"], _ = device_ms(small_mxu_step, None,
                                                    calls=5)
        finally:
            mcmod._tail_adds = tail_adds
    padded["small_mxu_step"] = step
    stage["padded_backwards"] = padded
    log(f"small sphere mxu step, new / old / new / old layout: "
        + ", ".join(f"{step[k + '_ms']:.3f} ms ({step[k + '_device_ms']:.3f}"
                    f" device)" for k in ("new", "old", "new2", "old2")))

    # -- 7. the marching-tetrahedra path, PLY I/O and the native runtime ----
    stage["sharded"] = sharded_times
    stage["mt"] = mt_path(counted, v_b, f_b, cam_b.origins, cam_b.dirs)
    stage["sharded"].update(sharded_profiles())

    log(json.dumps({"stages": stage}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
