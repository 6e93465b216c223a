#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every kernel of ``primitive3d_tpu_torch/csrc`` with nvcc and
drives two paths through the entry points a user calls, each with the
kernel launch counts set to 0 just before it and read just after:

  * the serving path (marching cubes -> cluster ray caster -> cast) at two
    full-size configurations:
      - bunny: ``examples/data/bunny.npy`` (66^3) -> 13,282 vertices /
        26,560 faces -> 512x512 camera rays, resident cast tier;
      - flagship sphere: the 256^3 sphere SDF (r = 0.8 on [-1, 1]^3) ->
        1088x1920 camera rays, stream cast tier with clusters of 128;
  * the training path: one differentiable SDF-fitting step
    (``sdf_fitting_loss(..., backend="pallas")`` then ``backward()``) at the
    configuration of FLAGSHIP_r5.json and tools/flagship_probe.py: the
    256^3 sphere, a 425,984-face soup, 1088x1920 rays, target depth 1.7.

It checks the outputs (exact counts, card against CPU, the flagship step's
depth against the analytic sphere and its loss and gradient norm against
FLAGSHIP_r5.json), runs three Adam steps of the flagship fitting recipe,
holds each kernel against its plain PyTorch version on the card at the
shapes its path gives it, times the kernels and the paths' stages with CUDA
events, and prints:

  * a ``stages`` JSON line: the paths' stage times;
  * a ``kernels`` JSON line: each kernel's launches on the main paths,
    error against its plain version, its time, the plain version's time,
    its lower bound on this card and the time of one PyTorch call that
    computes the same function, where there is one;
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
SERVING_KERNELS = ("mc_masks", "cluster_cast_resident", "cluster_cast_stream")
TRAINING_KERNELS = ("mc_masks", "cluster_cast_stream", "plane_scatter")


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


def profile_step(step, top=8):
    """One ``step()`` under ``torch.profiler``: logs the kernels and the
    autograd nodes with the most device time, and returns the device busy
    share of the step's wall time (None where the profiler saw no device
    time)."""
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
        log("profile of one training step: no device time seen")
        return dict(profiled_wall_ms=wall_us / 1e3, device_busy_share=None)
    for title, rows, own in (
            ("kernels", kern, True),
            ("backward nodes", [e for e in avgs if e.key.startswith(
                "autograd::engine::evaluate_function")], False)):
        rows = sorted(rows, key=lambda e: -dev_us(e, own))[:top]
        log(f"profile of one training step, {title} by device ms: "
            + "; ".join(f"{e.key[:60]} {dev_us(e, own) / 1e3:.3f} x{e.count}"
                        for e in rows))
    log(f"profile of one training step: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f})")
    return dict(profiled_wall_ms=wall_us / 1e3,
                device_busy_share=busy_us / wall_us)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from primitive3d_tpu_torch import (create_raycaster, marching_cubes,
                                       marching_cubes_soup, render_depth,
                                       sdf_fitting_loss)
    from primitive3d_tpu_torch.core.config import RayCastConfig
    from primitive3d_tpu_torch.kernels import _build
    from primitive3d_tpu_torch.kernels import mc_masks as mk
    from primitive3d_tpu_torch.kernels import raycast_kernel as rk
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
    step_kw = dict(thresh=0.0, vert_capacity=FLAGSHIP_VC,
                   face_capacity=FLAGSHIP_FC, max_dist=10.0,
                   backend="pallas", **BOX)
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
    # the forward cast's and the backward plane scatter's inputs are kept
    # for the kernel checks
    stream_args, scatter_args = [], []
    cluster_cast_stream, plane_scatter = rk.cluster_cast_stream, \
        rk.plane_scatter

    def recording_stream(*args):
        stream_args.append(args)
        return cluster_cast_stream(*args)

    def recording_scatter(*args):
        scatter_args.append(args)
        return plane_scatter(*args)

    def train_step():
        dens = sphere_dev.clone().requires_grad_()
        loss = sdf_fitting_loss(dens, o_f, d_f, target_f, **step_kw)
        loss.backward()
        return loss, dens.grad

    rk.cluster_cast_stream = recording_stream
    rk.plane_scatter = recording_scatter
    try:
        (loss_f, grad_f), training = counted("training", TRAINING_KERNELS,
                                             train_step)
    finally:
        rk.cluster_cast_stream = cluster_cast_stream
        rk.plane_scatter = plane_scatter
    check(len(stream_args) == 1, "the flagship forward ran no stream cast")
    check(len(scatter_args) == 1, "the flagship backward ran no plane scatter")

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
    launches = {k: serving[k] + training[k] for k in serving}
    kernels = []

    cx, cy, cz, cm = mk.fused_masks(sphere_dev, 0.0)
    px, py, pz, pm = mk.fused_masks_plain(sphere_dev, 0.0)
    err = max(int((a.int() - b.int()).abs().max())
              for a, b in ((cx, px), (cy, py), (cz, pz), (cm, pm)))
    check(err == 0, "mc_masks differs from its plain version")
    ms = event_ms(lambda: mk.fused_masks(sphere_dev, 0.0), iters=20)
    pms = event_ms(lambda: mk.fused_masks_plain(sphere_dev, 0.0),
                   iters=5)
    mbytes = nbytes(sphere_dev, cx, cy, cz, cm)
    kernels.append(dict(
        name=mk.KERNEL.name, route="cuda",
        source="primitive3d_tpu_torch/csrc/mc_masks.cu",
        replaces=mk.KERNEL.replaces, launches=launches[mk.KERNEL.name],
        max_abs_err=float(err), ms=ms, plain_ms=pms,
        bound_ms=mbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None))
    log(f"mc_masks 256^3: exact; {ms:.4f} ms (plain {pms:.3f} ms)")

    stage = {}
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
        args = (n, work) + ((bounds,) if rc.stream else ()) + (
            bvh.w, bvh.fin, rays, rc.max_dist)
        visits = torch.zeros(n.shape[0] * rk.NCH, dtype=torch.int32,
                             device=dev)
        dk, ik, fk = fn(*args, visits=visits)
        dpl, ipl, fpl = rk.cluster_cast_plain(n, work, bounds, bvh.w,
                                              bvh.fin, rays, rc.max_dist)
        agree = float((ik == ipl).float().mean())
        check(agree >= 0.9999, f"{kern.name}: sidx agrees on {agree}")
        hk = _finish_hits_fin(fk, dk, ik, op, dp, rc.max_dist)
        hp = _finish_hits_fin(fpl, dpl, ipl, op, dp, rc.max_dist)
        same = ik == ipl
        check(torch.allclose(hk.depth[same], hp.depth[same], rtol=1e-5,
                             atol=0), f"{kern.name}: refined depth differs")
        err = float((dk - dpl).abs().max())
        nvis = int(visits.sum())
        # (cluster, chunk) visits in the work list: what the plain version
        # does, and what the stream kernel would do without its early exit
        live = torch.arange(work.shape[1], device=dev)[None, :] < n[:, None]
        if rc.stream:
            bits = (work[:, :, None] >> torch.arange(rk.NCH, device=dev)) & 1
            flagged = int(bits.sum(dim=-1)[live].sum())
        else:
            flagged = int(n.sum())
        S = bvh.cluster_size
        ms = event_ms(lambda: fn(*args))
        pms = event_ms(lambda: rk.cluster_cast_plain(
            n, work, bounds, bvh.w, bvh.fin, rays, rc.max_dist),
            iters=3, warmup=1)
        ops = nvis * S * rk.RCHUNK * CAST_OPS_PER_TEST
        cbytes = nbytes(n, work, bounds, bvh.w, bvh.fin, rays, dk, ik, fk)
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        t_bytes = cbytes / HBM_BYTES_PER_S * 1e3
        kernels.append(dict(
            name=kern.name, route="cuda",
            source="primitive3d_tpu_torch/csrc/cluster_cast.cu",
            replaces=kern.replaces, launches=launches[kern.name],
            max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None))
        B = n.shape[0]
        log(f"{kern.name} ({name}): sidx agree {agree:.6f}, raw depth max "
            f"err {err}; {ms:.3f} ms (plain {pms:.2f} ms); {B} blocks, "
            f"{int(n.sum())} list entries, {nvis} visits of {flagged} in "
            f"the list ({nvis / (B * rk.NCH):.2f} per chunk), bound "
            f"{max(t_ops, t_bytes):.4f} ms")

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
                           kernel_ms=ms, cast_ms=t_cast,
                           mrays_per_s=R / (t_cast * 1e3), rays=R)
        log(f"path {name}: MC {t_mc:.3f} ms, cluster build {t_build:.3f} "
            f"ms, prep {t_prep:.3f} ms, kernel {ms:.3f} ms, cast "
            f"{t_cast:.3f} ms = {R / (t_cast * 1e3):.2f} Mrays/s")

    # the stream cast on the flagship step's own inputs: 3,328
    # identity-order clusters of the soup, whose padding rows are point
    # triangles; the winners' fin rows are the forward depth's planes
    sargs = stream_args[0]
    dk, ik, fk = rk.cluster_cast_stream(*sargs)
    dpl, ipl, fpl = rk.cluster_cast_plain(*sargs)
    same = ik == ipl
    agree = float(same.float().mean())
    check(agree >= 0.9999, f"{rk.STREAM.name} (training): sidx agrees on "
          f"{agree}")
    check(torch.equal(dk[same], dpl[same])
          and torch.equal(fk[same], fpl[same]),
          f"{rk.STREAM.name} (training): depth or fin rows differ")
    err = float((dk - dpl).abs().max())
    entry = next(k for k in kernels if k["name"] == rk.STREAM.name)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    log(f"{rk.STREAM.name} (training step's inputs): {sargs[0].shape[0]} "
        f"blocks, {sargs[3].shape[0]} clusters; sidx agree {agree:.6f}, "
        f"depth and fin rows equal where it agrees, raw depth max err {err}")

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
    cm_ms = event_ms(lambda: rk._cluster_masks(n4, e4, C4), iters=20)
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
        plain_ms=pms, bound_ms=sbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=lms))
    log(f"plane_scatter (flagship backward): equal bits over two launches, "
        f"max err {err:.3g} (relative {rel:.3g}); {ms:.4f} ms, of which the "
        f"(C, B) list view {cm_ms:.4f} ms (plain {pms:.3f} ms, index_add_ "
        f"{lms:.4f} ms); {C4} clusters x {B4} blocks, {hit_rays} rays with "
        f"a winner, bound {sbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")

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
    stage["training"].update(profile_step(step))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    log(json.dumps({"stages": stage}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
