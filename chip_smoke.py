#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every kernel of ``primitive3d_tpu_torch/csrc`` with nvcc, drives
the library's serving path (marching cubes -> cluster ray caster -> cast)
through the entry points a user calls, at two full-size configurations:

  * bunny: ``examples/data/bunny.npy`` (66^3) -> 13,282 vertices / 26,560
    faces -> 512x512 camera rays, resident cast tier;
  * flagship sphere: the 256^3 sphere SDF (r = 0.8 on [-1, 1]^3) -> 1088x1920
    camera rays, stream cast tier with clusters of 128;

checks the outputs, holds each kernel against its plain PyTorch version on
the card at the shapes the path gives it, times the kernels and the path's
stages with CUDA events, and prints:

  * a ``kernels`` JSON line: each kernel's launches on the main path, error
    against its plain version, its time, the plain version's time and its
    lower bound on this card;
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


def event_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() between two CUDA events."""
    from primitive3d_tpu_torch.core.timer import time_fn
    return time_fn(fn, iters=iters, warmup=warmup, device="cuda") * 1e3


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
    from primitive3d_tpu_torch import create_raycaster, marching_cubes
    from primitive3d_tpu_torch.core.config import RayCastConfig
    from primitive3d_tpu_torch.kernels import _build
    from primitive3d_tpu_torch.kernels import mc_masks as mk
    from primitive3d_tpu_torch.kernels import raycast_kernel as rk
    from primitive3d_tpu_torch.ops.marching_cubes import marching_cubes_counts
    from primitive3d_tpu_torch.raycast import _finish_hits_fin
    from primitive3d_tpu_torch.render.camera import camera_rays

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

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
    torch.cuda.synchronize()

    # -- 3. the main path, once, counted ------------------------------------
    _build.reset_launches()
    v_b, f_b = marching_cubes(bunny, 0.0, scale=1.0)
    rc_b = create_raycaster(v_b, f_b, backend="pallas")
    hits_b = rc_b.cast(cam_b.origins, cam_b.dirs)
    v_f, f_f = marching_cubes(sphere_dev, 0.0, scale=(-1.0, 1.0))
    rc_f = create_raycaster(v_f, f_f, backend="pallas")
    hits_f = rc_f.cast(cam_f.origins, cam_f.dirs)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    log(f"main-path launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

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

    # -- 5. each kernel against its plain version at the path's shapes -----
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

    log(json.dumps({"stages": stage}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
