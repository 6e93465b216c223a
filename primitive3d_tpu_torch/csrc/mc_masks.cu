// Marching-cubes mask pass for Hopper (sm_90a).
//
// Replaces: primitive3d_tpu/kernels/mc_masks.py:29 `_kernel` (wrapper
// `fused_masks`), the Pallas TPU kernel that sweeps x-slabs of the density
// grid with a one-row +x halo and writes the three edge-crossing masks and
// the 8-bit corner mask of every cube in one pass.
//
// What bounds it on this card: bytes. Each grid cell is read once (4 B) and
// about 4 B of masks are written per cell, with a handful of compares in
// between: at 256^3 that is ~67 MB in and ~67 MB out, ~40 us at 3.35 TB/s.
//
// Design: one thread per grid cell (x, y, z), C order, so a warp reads 32
// consecutive floats of one z-row; one row of blocks per x slice. The thread
// compares its own sample and its +x, +y, +z, +xy, +xz, +yz, +xyz
// neighbours with the threshold (the
// neighbour reads hit L1/L2: the +z one is the next lane's sample, the +y
// one the next row's) and writes each mask in its valid shape, so no Y/Z
// padding is needed (the TPU pads only for its (8, 128) tiling):
//   cx (X-1, Y, Z) int8, cy (X, Y-1, Z) int8, cz (X, Y, Z-1) int8,
//   cube mask (X-1, Y-1, Z-1) uint8 with bit k = corner k inside, corners
//   0..7 = (0,0,0) (1,0,0) (1,1,0) (0,1,0) (0,0,1) (1,0,1) (1,1,1) (0,1,1).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) mc_masks_kernel(
    const float* __restrict__ dens, float thresh, int X, int Y, int Z,
    int8_t* __restrict__ cx, int8_t* __restrict__ cy,
    int8_t* __restrict__ cz, uint8_t* __restrict__ cm) {
  // blockIdx.y is the x row; threads run over that row's Y*Z cells, so the
  // index math is 32-bit within a row and one 64-bit product per thread
  const int x = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Y * Z) return;
  const int y = t / Z;
  const int z = t - y * Z;
  const long long yz = (long long)Y * Z;
  const long long i = x * yz + t;
  const bool hx = x + 1 < X, hy = y + 1 < Y, hz = z + 1 < Z;

  const int o000 = __ldg(dens + i) > thresh;
  const int o100 = hx && __ldg(dens + i + yz) > thresh;
  const int o010 = hy && __ldg(dens + i + Z) > thresh;
  const int o001 = hz && __ldg(dens + i + 1) > thresh;
  if (hx) cx[i] = (int8_t)(o000 ^ o100);  // (x*Y + y)*Z + z == i
  if (hy) cy[((long long)x * (Y - 1) + y) * Z + z] = (int8_t)(o000 ^ o010);
  if (hz) cz[((long long)x * Y + y) * (Z - 1) + z] = (int8_t)(o000 ^ o001);
  if (hx && hy && hz) {
    const int o110 = __ldg(dens + i + yz + Z) > thresh;
    const int o101 = __ldg(dens + i + yz + 1) > thresh;
    const int o011 = __ldg(dens + i + Z + 1) > thresh;
    const int o111 = __ldg(dens + i + yz + Z + 1) > thresh;
    const int m = o000 | (o100 << 1) | (o110 << 2) | (o010 << 3) |
                  (o001 << 4) | (o101 << 5) | (o111 << 6) | (o011 << 7);
    cm[((long long)x * (Y - 1) + y) * (Z - 1) + z] = (uint8_t)m;
  }
}

}  // namespace

extern "C" int mc_masks(const float* dens, float thresh, int X, int Y, int Z,
                        int8_t* cx, int8_t* cy, int8_t* cz, uint8_t* cm,
                        cudaStream_t stream) {
  if (X < 2 || Y < 2 || Z < 2 || X > 65535 || (long long)Y * Z > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const dim3 grid((Y * Z + threads - 1) / threads, X);
  mc_masks_kernel<<<grid, threads, 0, stream>>>(
      dens, thresh, X, Y, Z, cx, cy, cz, cm);
  return (int)cudaGetLastError();
}
