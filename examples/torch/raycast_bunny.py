"""Ray-cast the bunny on the port: depth / normal / primitive-id buffers.

The PyTorch counterpart of ``examples/raycast_bunny.py``: marching cubes on
the bunny grid, the cluster caster, a 512x512 depth and normal image, and
the mesh and a shaded PPM written to the working directory.

    python examples/torch/raycast_bunny.py [--device cuda|cpu]
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import primitive3d_tpu_torch as p3t  # noqa: E402
from primitive3d_tpu_torch.render.camera import camera_rays  # noqa: E402

DATA = os.path.join(ROOT, "examples", "data", "bunny.npy")


def main(device: str) -> None:
    v, f = p3t.marching_cubes(np.load(DATA), 0.0, scale=1.0, device=device)
    print(f"mesh: {v.shape[0]} verts, {f.shape[0]} faces")
    p3t.save_mesh(v, f, filename="bunny.ply")

    H = W = 512
    cam = camera_rays(H, W, origin=(0.5, 0.5, -1.5), look_at=(0.5, 0.5, 0.5),
                      fov_y=35.0)
    rc = p3t.create_raycaster(v, f, backend="pallas", device=device)
    with p3t.Timer("cast 512x512 rays: {:.3f}s", device=device):
        hits = rc.cast(cam.origins, cam.dirs)

    normal = cam.to_image(hits.normals.cpu().numpy(), H, W)
    fid = cam.to_image(hits.face_id.cpu().numpy(), H, W)
    print(f"hit fraction: {(fid >= 0).mean():.3f}")

    # a shaded PPM: normal . light, misses black
    light = np.array([0.3, -0.5, -0.8])
    light = light / np.linalg.norm(light)
    shade = np.clip(-(normal @ light), 0, 1)
    img = (np.where(fid >= 0, shade, 0.0) * 255).astype(np.uint8)
    with open("bunny_depth.ppm", "wb") as fh:
        fh.write(f"P5\n{W} {H}\n255\n".encode())
        fh.write(img.tobytes())
    print("wrote bunny.ply and bunny_depth.ppm")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
