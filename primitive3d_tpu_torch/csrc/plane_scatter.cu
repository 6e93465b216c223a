// Plane-cotangent scatter for Hopper (sm_90a): the stream-tier backward of
// the differentiable cluster cast.
//
// Replaces the Pallas TPU kernel primitive3d_tpu/kernels/raycast_kernel.py:1279
// `_kernel_plane_bwd` (wrapper `_plane_scatter_ws`, :1351). It computes
//   out[c*S + j] = sum of g[ray] over the rays whose winner widx[ray] is
//                  c*S + j and whose 256-ray chunk is flagged for cluster c
//                  in its 2048-ray block's stream work list;
// other rays add nothing. The TPU walks the ray blocks in grid order with
// the output resident in VMEM, and forms each visit's sum as a one-hot
// matrix product on its matrix unit; the card needs neither.
//
// What bounds it on this card: bytes. The function reads g (16 B a ray),
// widx (4 B a ray) and the per-cluster list (4 B per block and cluster) once
// and writes 16 B per row: about 62 MB at the flagship size (2,088,960 rays,
// 3,328 clusters of 128), 19 us at 3.35 TB/s. It does next to no arithmetic.
//
// Design (simple first, deterministic, no atomics): one CUDA block of S
// threads per cluster c; thread j owns output row c*S + j. The wrapper turns
// the stream list into a per-cluster view cmask (C, B): the chunk mask of
// cluster c's word in block b's list, 0 where c is not listed. A block reads
// its row of cmask S words at a time into shared memory and walks the ray
// blocks b in ascending order, and within a block its set chunk bits r in
// ascending order. For each listed (b, r) it stages the chunk's 256 winners
// in shared memory; __syncthreads_or skips the chunk if no ray's winner is
// in the cluster. Otherwise it stages the chunk's 256 float4 cotangents, and
// thread j adds, in ray order, every cotangent whose winner is its row. So
// each row's sum runs in ascending ray order, every launch gives the same
// bits, and each row is written once, at the end. Each listed visit re-reads
// its chunk's 1 KB of winners (and 4 KB of cotangents where the cluster won
// a ray), so the kernel moves several times its byte bound; a form that
// sorts the rays by winner once would not.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RCHUNK = 256;  // rays per chunk
constexpr int NCH = 8;       // chunks per 2048-ray block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr int MAX_S = 256;   // largest cluster size = most threads a block

__global__ void __launch_bounds__(MAX_S) plane_scatter_kernel(
    const int* __restrict__ cmask, int B, const int* __restrict__ widx,
    const float4* __restrict__ g, int S, float4* __restrict__ out) {
  __shared__ int swords[MAX_S];
  __shared__ int sw[RCHUNK];
  __shared__ float4 sg[RCHUNK];
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const int lo = c * S;
  const int row = lo + j;
  const int* cm = cmask + (long long)c * B;
  float ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;

  for (int b0 = 0; b0 < B; b0 += S) {
    __syncthreads();  // every thread is done with the previous tile of words
    swords[j] = b0 + j < B ? cm[b0 + j] : 0;
    __syncthreads();
    const int nb = min(S, B - b0);
    for (int bb = 0; bb < nb; ++bb) {
      int mask = swords[bb] & ((1 << NCH) - 1);  // block-uniform
      while (mask != 0) {
        const int r = __ffs(mask) - 1;
        mask &= mask - 1;
        const long long base = (long long)(b0 + bb) * MBLOCK + r * RCHUNK;
        __syncthreads();  // every thread is done with the previous chunk
        int any = 0;
        for (int i = j; i < RCHUNK; i += S) {
          const int w = widx[base + i];
          sw[i] = w;
          any |= (unsigned)(w - lo) < (unsigned)S;
        }
        if (!__syncthreads_or(any)) continue;  // no winner in this cluster
        for (int i = j; i < RCHUNK; i += S) sg[i] = g[base + i];
        __syncthreads();
#pragma unroll 8
        for (int i = 0; i < RCHUNK; ++i) {
          if (sw[i] == row) {
            const float4 v = sg[i];
            ax = __fadd_rn(ax, v.x);
            ay = __fadd_rn(ay, v.y);
            az = __fadd_rn(az, v.z);
            aw = __fadd_rn(aw, v.w);
          }
        }
      }
    }
  }
  out[row] = make_float4(ax, ay, az, aw);
}

}  // namespace

// cmask (C, B) int32 chunk masks per cluster and block; widx (B * 2048,)
// int32 winners (-1 for none); g (B * 2048, 4) float32 cotangents; out
// (C * S, 4) float32, every row written.
extern "C" int plane_scatter(const int* cmask, int B, const int* widx,
                             const float* g, int C, int S, float* out,
                             cudaStream_t stream) {
  if (S < 1 || S > MAX_S || (S & (S - 1)) != 0 || B < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  plane_scatter_kernel<<<C, S, 0, stream>>>(
      cmask, B, widx, reinterpret_cast<const float4*>(g), S,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
