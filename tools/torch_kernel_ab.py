#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's mask and work-list kernels of one or more
checkouts side by side on one card, and split the work-list cull into its
phases.

Usage (from the repository root, on a machine with a CUDA card):

    python3 tools/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (``.`` for this
one); they run in the order given, each in a process of its own that
imports that checkout's ``primitive3d_tpu_torch`` and builds its kernels,
so ``parent . . parent`` alternates two commits on the same card. For each
checkout it prints one JSON line with, at the serving paths' inputs (the
256^3 sphere SDF and the 66^3 bunny for ``mc_masks``; the bunny's 512x512
frame, both tiers, and the flagship's 1088x1920 frame for ``stream_cull``):

  * ``ms``: the median over 20 calls of one wrapper call between two CUDA
    events, the host's part included;
  * ``device_ms``: the device time of the kernel that ``torch.profiler``
    records over 20 back-to-back wrapper calls, per call;
  * ``phases`` (flagship): ``stream_cull`` rebuilt from the checkout's
    source with one more phase removed at each step (the sort; the pass
    that writes the unflagged tail; the slab tests; the whole cluster
    pass, leaving the ray intervals), each the mean of 20 back-to-back
    launches between two CUDA events. Each removal is a text edit of the
    source that this script knows for both designs the cull has had: a
    block scan per tile of 256 clusters, and a lane per cluster ranked by
    warp ballots.

It imports neither JAX nor the JAX package.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CALLS = 20
# the edits that remove a phase, per design: (text, replacement) in order
# of removal; a design is known by its first text
PHASES = {
    "block_scan": [
        ("  if (STREAM) {\n    // -- bitonic sort",
         "  if (STREAM && AB < 1) {\n    // -- bitonic sort"),
        ("  count = 0;\n  for (int c0 = 0; c0 < C; c0 += THREADS) {",
         "  count = 0;\n  for (int c0 = 0; c0 < C && AB < 2; c0 += THREADS) {"),
        ("for (int r = 0; r < NCH; ++r) {",
         "for (int r = 0; r < NCH && AB < 3; ++r) {"),
        ("  int count = 0;  // flagged clusters (stream) or pairs (resident) "
         "so far\n  for (int c0 = 0; c0 < C; c0 += THREADS) {",
         "  int count = 0;  // flagged clusters (stream) or pairs (resident) "
         "so far\n  for (int c0 = 0; c0 < C && AB < 4; c0 += THREADS) {"),
    ],
    "warp_ranks": [
        ("  if (STREAM) {\n    if (n <= RANK_MAX) {",
         "  if (STREAM && AB < 1) {\n    if (n <= RANK_MAX) {"),
        ("  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {\n    const int c = c0 "
         "+ lane;\n    const bool live",
         "  for (int c0 = c_lo; c0 < c_hi && AB < 2; c0 += 32) {\n    const "
         "int c = c0 + lane;\n    const bool live"),
        ("for (int r = 0; r < NCH; ++r) {\n        float tl, th;",
         "for (int r = 0; r < NCH && AB < 3; ++r) {\n        float tl, th;"),
        ("  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {\n    const int c = c0 "
         "+ lane;\n    unsigned mask = 0;",
         "  for (int c0 = c_lo; c0 < c_hi && AB < 4; c0 += 32) {\n    const "
         "int c = c0 + lane;\n    unsigned mask = 0;"),
    ],
}
PHASE_NAMES = ["full", "no sort", "no tail pass", "no slab tests",
               "intervals only"]


def sphere_grid(n=256, r=0.8):
    ax = np.linspace(-1.0, 1.0, n).astype(np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.float32(r) - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def phase_variants(source, build_dir, nvcc, flags):
    """The cull source compiled with 0..4 phases removed: ctypes functions."""
    text = open(source).read()
    edits = next((e for e in PHASES.values() if text.count(e[0][0]) == 1),
                 None)
    if edits is None:
        return None
    text = "#ifndef AB\n#define AB 0\n#endif\n" + text
    for old, new in edits:
        text = text.replace(old, new, 1)
    src = os.path.join(build_dir, "cull_phases.cu")
    with open(src, "w") as f:
        f.write(text)
    procs = []
    for k in range(len(PHASE_NAMES)):
        out = os.path.join(build_dir, f"cull_phases{k}.so")
        procs.append((out, subprocess.Popen(
            [nvcc, *flags, f"-DAB={k}", "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = []
    for out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(log)
        fns.append(ctypes.CDLL(out).stream_cull)
    return fns


def worker(root):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    from primitive3d_tpu_torch import create_raycaster, marching_cubes
    from primitive3d_tpu_torch.kernels import _build
    from primitive3d_tpu_torch.kernels import mc_masks as mk
    from primitive3d_tpu_torch.kernels import raycast_kernel as rk
    from primitive3d_tpu_torch.render.camera import camera_rays

    dev = torch.device("cuda")
    _build.build(["mc_masks.cu", "stream_cull.cu"])

    def per_call(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(CALLS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[CALLS // 2]

    def device(fn, symbol):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0) or 0.0
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and symbol in e.key)
        return us / 1e3 / CALLS if us > 0 else None

    def back_to_back(fn):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / CALLS

    out = dict(root=root)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bunny = np.load(os.path.join(here, "examples", "data", "bunny.npy"))
    grids = {"256^3": torch.from_numpy(sphere_grid()).to(dev),
             "66^3": torch.from_numpy(bunny).to(dev)}
    for name, g in grids.items():
        want = mk.fused_masks_plain(g, 0.0)
        exact = all(torch.equal(a, b) for a, b in zip(mk.fused_masks(g, 0.0),
                                                      want))
        call = lambda: mk.fused_masks(g, 0.0)  # noqa: E731
        out[f"mc_masks {name}"] = dict(exact=exact, ms=per_call(call),
                                       device_ms=device(call, "mc_masks"))

    cams = {"bunny": (grids["66^3"], 1.0, camera_rays(
                512, 512, origin=(0.5, 0.5, -1.5), look_at=(0.5, 0.5, 0.5),
                fov_y=35.0)),
            "flagship": (grids["256^3"], (-1.0, 1.0), camera_rays(
                1088, 1920, (0.0, 0.0, 2.5), (0.0, 0.0, 0.0)))}
    flagship = None
    for name, (g, scale, cam) in cams.items():
        v, f = marching_cubes(g, 0.0, scale=scale)
        boxes = create_raycaster(v, f, backend="pallas").cbvh.boxes
        o = torch.from_numpy(cam.origins).to(dev)
        d = torch.from_numpy(cam.dirs).to(dev)
        pad = (-o.shape[0]) % rk.MBLOCK
        o = torch.cat([o, torch.zeros((pad, 3), device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), device=dev)])
        rays = rk._ray_rows(o, d, o.shape[0])
        for stream in ((False, True) if name == "bunny" else (True,)):
            got = rk.work_lists(boxes, rays, 10.0, stream)
            want = rk.work_lists_plain(boxes, rays, 10.0, stream)
            exact = (torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1])
                     and (not stream or torch.equal(
                         got[2].view(torch.int32), want[2].view(torch.int32))))
            call = lambda: rk.work_lists(boxes, rays, 10.0,  # noqa: E731
                                         stream)
            out[f"stream_cull {name} {'stream' if stream else 'resident'}"] \
                = dict(exact=exact, ms=per_call(call),
                       device_ms=device(call, "cull_kernel"))
        flagship = (boxes, rays)

    with tempfile.TemporaryDirectory(dir=os.path.join(here, "_scratch")
                                     if os.path.isdir(os.path.join(
                                         here, "_scratch")) else None) as tmp:
        fns = phase_variants(
            os.path.join(root, "primitive3d_tpu_torch", "csrc",
                         "stream_cull.cu"), tmp, _build.nvcc(),
            _build.NVCC_FLAGS)
        if fns is not None:
            boxes, rays = flagship
            C, B = boxes.shape[0], rays.shape[1] // rk.MBLOCK
            n = torch.empty((B,), dtype=torch.int32, device=dev)
            work = torch.empty((B, C), dtype=torch.int32, device=dev)
            bounds = torch.empty((B, C), dtype=torch.float32, device=dev)
            phases = {}
            for name, fn in zip(PHASE_NAMES, fns):
                fn.argtypes = rk.CULL.argtypes
                fn.restype = ctypes.c_int

                def launch():
                    err = fn(rays.data_ptr(), rays.shape[1], B,
                             boxes.data_ptr(), C, 10.0, 1, n.data_ptr(),
                             work.data_ptr(), bounds.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                phases[name] = back_to_back(launch)
            out["stream_cull flagship phases"] = phases
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) > 2 and argv[1] == "--worker":
        worker(argv[2])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for root in argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
