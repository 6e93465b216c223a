"""Meshes and rays for the stream tier's tests, without JAX: the card
tests (``tests/test_torch_cuda.py``) run where JAX is not installed."""
import numpy as np
import torch

from primitive3d_tpu_torch.bvh.clusters import build_mxu_clusters
from primitive3d_tpu_torch.kernels import raycast_kernel as rk
from primitive3d_tpu_torch.render.camera import camera_rays


def cube_tris(n=8):
    """The surface of [0, 1]^3, each face an n x n grid of quads, face by
    face: in identity order every cluster of 16 lies in one face, so its box
    is flat. Zero coordinates are -0.0, as an amin over a -0.0 gives."""
    g = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    tris = []
    for axis in range(3):
        for side in (0.0, 1.0):
            for i in range(n):
                for j in range(n):
                    q = [(g[i], g[j]), (g[i + 1], g[j]), (g[i + 1], g[j + 1]),
                         (g[i], g[j + 1])]
                    pts = [np.insert(np.array(p, np.float32), axis, side)
                           for p in q]
                    tris += [[pts[0], pts[1], pts[2]],
                             [pts[0], pts[2], pts[3]]]
    t = np.array(tris, np.float32)
    return np.where(t == 0.0, np.float32(-0.0), t)


def pad_rays(o, d):
    pad = (-o.shape[0]) % rk.MBLOCK
    return (np.concatenate([o, np.zeros((pad, 3), np.float32)]),
            np.concatenate([d, np.ones((pad, 3), np.float32)]))


def flat_case():
    """The cube in identity-order clusters of 16, and 2,048 rays in chunks
    of 256: 1,024 camera rays; 256 rays along +z from origins on the x and
    y planes of cluster boxes (0 * inf in the slab test); 256 from x = +0.0
    on the cube's x = -0.0 face, heading +x, whose chunk interval gives
    the products -0.0 and a zero entry bound; 512 rays from inside."""
    tris = cube_tris()
    bvh = build_mxu_clusters(torch.from_numpy(tris), cluster_size=16,
                             order="identity")
    cam = camera_rays(32, 32, (0.3, 0.4, -2.0), (0.5, 0.5, 0.5))
    bx = bvh.boxes.numpy()
    k = np.arange(256) * 5 % bx.shape[0]
    o_ap = np.stack([bx[k, 0], bx[k, 4], np.full(256, -1.0, np.float32)], 1)
    d_ap = np.tile(np.float32([0.0, 0.0, 1.0]), (256, 1))
    rng = np.random.default_rng(5)
    yz = rng.uniform(0.1, 0.9, (256, 2)).astype(np.float32)
    o_z = np.concatenate([np.zeros((256, 1), np.float32), yz], 1)
    d_z = np.concatenate([np.ones((256, 1)), rng.uniform(
        -0.3, 0.3, (256, 2))], 1).astype(np.float32)
    o_in = rng.uniform(0.2, 0.8, (512, 3)).astype(np.float32)
    d_in = rng.standard_normal((512, 3)).astype(np.float32)
    o = np.concatenate([cam.origins, o_ap, o_z, o_in]).astype(np.float32)
    d = np.concatenate([cam.dirs, d_ap, d_z, d_in]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return bvh, o, d


def rows(o, d):
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    return torch.cat([d, torch.linalg.cross(o, d, dim=-1), o],
                     dim=1).T.contiguous()


CULL_CASES = ("straddle", "zero_dir", "huge", "degenerate", "nan", "none",
              "all")


def cull_case(name, C=96, seed=0):
    """Boxes (C, 6) and 2,048 rays (one work-list block, eight chunks) for
    the cull, as numpy float32, each case aimed at one hazard of the
    kernel's four-corner slab test:

    * straddle: every chunk's directions straddle zero on x or y;
    * zero_dir: chunks with a direction component of exactly +0.0 or
      -0.0 (1/d clipped to +-1e18) beside ordinary ones;
    * huge: boxes and origins at +-1e37 and +-3e38 (differences that
      overflow to +-inf);
    * degenerate: point boxes (hi == lo) and flat boxes among the rest;
    * nan: a NaN box coordinate and a chunk with a NaN direction;
    * none: every box behind the rays or past max_dist 10 (n = 0);
    * all: boxes that every ray of every chunk enters (n = C or 8 C).
    """
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.0, 1.0, (C, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.6, (C, 3))], 1)
    boxes[::4, [2, 5]] -= 10.0  # behind the rays: never flagged
    o = np.tile(np.float32([0.0, 0.0, -3.0]), (2048, 1))
    o += rng.uniform(-0.2, 0.2, (2048, 3))
    d = np.stack([rng.uniform(-0.4, 0.4, 2048), rng.uniform(-0.4, 0.4, 2048),
                  np.ones(2048)], 1)
    if name == "straddle":
        d[:, :2] = rng.uniform(-0.05, 0.05, (2048, 2))
    elif name == "zero_dir":
        d[0:256, 0] = 0.0
        d[256:512, 1] = -0.0
        d[512:768, :2] = 0.0
        d[768:1024, 0] = np.where(np.arange(256) % 2, 0.0, -0.0)
    elif name == "huge":
        boxes[: C // 4] *= 1e37
        boxes[C // 4: C // 2, [0, 3]] = [-3e38, 3e38]
        boxes[C // 2: C // 2 + 4, [2, 5]] = [3e38, 3e38]
        o[0:256] = [1e37, -1e37, -3e38]
        o[256:512, 2] = 3e38
        d[512:768] = [1e-30, -1e-30, 1.0]
    elif name == "degenerate":
        boxes[::3, 3:] = boxes[::3, :3]
        boxes[1::5, 5] = boxes[1::5, 2]
    elif name == "nan":
        boxes[3, 1] = np.nan
        boxes[7, 4] = np.nan
        d[300] = [np.nan, 0.0, 1.0]
        o[1500, 2] = np.nan
    elif name == "none":
        boxes[:, 2] = rng.uniform(-20.0, -10.0, C)
        boxes[:, 5] = boxes[:, 2] + 1.0
        boxes[: C // 2, 2] = 20.0
        boxes[: C // 2, 5] = 21.0
    elif name == "all":
        boxes[:, :3] = -5.0 - rng.uniform(0.0, 1.0, (C, 3))
        boxes[:, 3:] = 5.0 + rng.uniform(0.0, 1.0, (C, 3))
    return (boxes.astype(np.float32), o.astype(np.float32),
            d.astype(np.float32))
