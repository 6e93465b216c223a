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
// What bounds it on this card: bytes. The function reads widx (4 B a ray),
// the cotangents of the rays with a winner (16 B each) and the live list
// words once, and writes 16 B per row: about 25 MB at the flagship size
// (2,088,960 rays, 3,328 clusters of 128), 7.5 us at 3.35 TB/s. It does
// next to no arithmetic.
//
// Design: order the rays that add to a row by that row once, then sum each
// row in ray order. Each row is the float32 sum of its cotangents in
// ascending ray order (__fadd_rn from 0), every launch gives the same bits,
// and there are no float atomics.
//   * pass 1, `key_kernel`, a block per 2048-ray block b: block b's list
//     goes into a table in shared memory, one byte of chunk bits per
//     cluster (C <= 32,767 clusters, so at most 32 KB). Each ray whose
//     winner's cluster flags its chunk gets the key (row << 11) | its index
//     in the block; the valid keys go to the front of shared memory (a
//     shared counter), a bitonic sort of the next power of two of them
//     orders them, and they are written to the block's slice of `keys`,
//     their count to nvalid[b]. A block with no such ray sorts nothing. For each cluster that won a ray of
//     the block, bit b of the cluster's row of `bitmap` (C, ceil(B / 32))
//     is set with an integer atomicOr, whose result does not depend on the
//     order of the atomics;
//   * pass 2, `sum_kernel`, a block of max(32, S) threads per cluster c:
//     thread j owns row c*S + j. The block walks the blocks b whose bit is
//     set, in ascending order; each warp finds the cluster's run of keys in
//     block b's sorted slice by a 32-way search (three rounds for 2,048
//     keys), and each thread finds its row's run in it by a binary search
//     and adds those rays' cotangents in order. Every row is written once,
//     zeros where no ray adds to it. No barrier in either walk.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RCHUNK = 256;  // rays per chunk
constexpr int NCH = 8;       // chunks per 2048-ray block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr int LOCAL_BITS = 11;  // log2(MBLOCK): a ray's index in its block
constexpr int KEY_THREADS = MBLOCK / 2;  // pass 1: two keys a thread
constexpr int MAX_S = 256;   // largest cluster size = most threads a block
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;  // sorts after every valid key

__global__ void __launch_bounds__(KEY_THREADS) key_kernel(
    const int* __restrict__ nwork, const int* __restrict__ entries,
    int stride, const int* __restrict__ widx, int C, int S, int W,
    unsigned long long* __restrict__ keys, int* __restrict__ nvalid,
    unsigned* __restrict__ bitmap) {
  extern __shared__ unsigned long long sk[];  // MBLOCK keys, then the table
  unsigned char* table = reinterpret_cast<unsigned char*>(sk + MBLOCK);
  __shared__ int count;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < (C + 3) / 4; i += KEY_THREADS) {
    reinterpret_cast<unsigned*>(table)[i] = 0u;
  }
  if (t == 0) count = 0;
  __syncthreads();
  const int n = nwork[b];
  for (int e = t; e < n; e += KEY_THREADS) {
    const int word = entries[(long long)b * stride + e];
    const int c = word >> 16;
    if (c < C) table[c] = (unsigned char)(word & 0xFF);
  }
  __syncthreads();
  const long long rows = (long long)C * S;
  // the valid keys to the front, in any order: the sort below orders them
  for (int i = t; i < MBLOCK; i += KEY_THREADS) {
    const int w = widx[(long long)b * MBLOCK + i];
    if (w >= 0 && w < rows && ((table[w / S] >> (i / RCHUNK)) & 1)) {
      sk[atomicAdd(&count, 1)] = ((unsigned long long)w << LOCAL_BITS) | i;
    }
  }
  __syncthreads();
  const int nv = count;
  int m = 2;  // the sort's size: a power of two >= nv
  while (m < nv) m <<= 1;
  for (int i = nv + t; i < m; i += KEY_THREADS) sk[i] = NONE;
  __syncthreads();
  // bitonic sort of the m keys, ascending (all keys are distinct)
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (t < m / 2) {
        const int i = 2 * t - (t & (j - 1));  // bit j of i is clear
        const unsigned long long x = sk[i], y = sk[i + j];
        if ((x > y) == ((i & k) == 0)) {
          sk[i] = y;
          sk[i + j] = x;
        }
      }
      __syncthreads();
    }
  }
  unsigned long long* kb = keys + (long long)b * MBLOCK;
  for (int i = t; i < nv; i += KEY_THREADS) {
    const unsigned long long key = sk[i];
    kb[i] = key;
    const int c = (int)((key >> LOCAL_BITS) / S);
    if (i == 0 || (int)((sk[i - 1] >> LOCAL_BITS) / S) != c) {
      atomicOr(bitmap + (long long)c * W + (b >> 5), 1u << (b & 31));
    }
  }
  if (t == 0) nvalid[b] = nv;
}

// The first index in [lo, hi) of the sorted a whose key is >= x (hi if
// none), found by the whole warp: each round each lane probes one of 32
// evenly spaced keys.
__device__ __forceinline__ int warp_lower_bound(
    const unsigned long long* __restrict__ a, int lo, int hi,
    unsigned long long x, int lane) {
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const int less = __popc(__ballot_sync(FULL, p < hi && a[p] < x));
    if (less == 0) return lo;
    const int nhi = min(lo + less * step, hi);
    lo += (less - 1) * step + 1;
    hi = nhi;
  }
  return lo;
}

__global__ void __launch_bounds__(MAX_S) sum_kernel(
    const unsigned long long* __restrict__ keys,
    const int* __restrict__ nvalid, const unsigned* __restrict__ bitmap,
    int W, const float4* __restrict__ g, int S, float4* __restrict__ out) {
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const long long row = (long long)c * S + j;
  const unsigned long long first = (unsigned long long)c * S << LOCAL_BITS;
  const unsigned long long past = (unsigned long long)(c + 1) * S
                                  << LOCAL_BITS;
  const unsigned long long mine = (unsigned long long)row << LOCAL_BITS;
  float ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;
  for (int wi = 0; wi < W; ++wi) {
    for (unsigned bits = bitmap[(long long)c * W + wi]; bits != 0;
         bits &= bits - 1) {
      const int b = wi * 32 + __ffs(bits) - 1;
      const unsigned long long* kb = keys + (long long)b * MBLOCK;
      const int lo = warp_lower_bound(kb, 0, nvalid[b], first, lane);
      const int hi = warp_lower_bound(kb, lo, nvalid[b], past, lane);
      if (j >= S) continue;
      int s = lo, e = hi;  // this row's run: binary search in [lo, hi)
      while (s < e) {
        const int mid = (s + e) >> 1;
        if (kb[mid] < mine) s = mid + 1; else e = mid;
      }
      const float4* gb = g + (long long)b * MBLOCK;
      for (int i = s; i < hi && kb[i] >> LOCAL_BITS == (unsigned long long)row;
           ++i) {
        const float4 v = gb[kb[i] & (MBLOCK - 1)];
        ax = __fadd_rn(ax, v.x);
        ay = __fadd_rn(ay, v.y);
        az = __fadd_rn(az, v.z);
        aw = __fadd_rn(aw, v.w);
      }
    }
  }
  if (j < S) out[row] = make_float4(ax, ay, az, aw);
}

}  // namespace

// n (B,) int32 and entries (B, stride) int32: the forward's stream list;
// widx (B * 2048,) int32 winners (-1 for none); g (B * 2048, 4) float32
// cotangents; out (C * S, 4) float32, every row written. Scratch: keys
// (B * 2048,) uint64, nvalid (B,) int32, bitmap (C * ceil(B / 32),) uint32.
// `passes`: bit 0 runs pass 1 (with the bitmap's zero fill), bit 1 pass 2;
// 3 for the function (a single pass only to time it).
extern "C" int plane_scatter(const int* n, const int* entries, int stride,
                             int B, const int* widx, const float* g, int C,
                             int S, unsigned long long* keys, int* nvalid,
                             unsigned* bitmap, float* out, int passes,
                             cudaStream_t stream) {
  if (S < 1 || S > MAX_S || (S & (S - 1)) != 0 || B < 1 || C < 1 ||
      C > 32767 || stride < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int W = (B + 31) / 32;
  if (passes & 1) {
    cudaError_t err = cudaMemsetAsync(
        bitmap, 0, sizeof(unsigned) * (size_t)C * W, stream);
    if (err != cudaSuccess) return (int)err;
    // up to 48 KB besides the static count: past the default limit
    const int bytes = MBLOCK * 8 + (C + 3) / 4 * 4;
    cudaFuncSetAttribute(key_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    key_kernel<<<B, KEY_THREADS, bytes, stream>>>(
        n, entries, stride, widx, C, S, W, keys, nvalid, bitmap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    sum_kernel<<<C, S < 32 ? 32 : S, 0, stream>>>(
        keys, nvalid, bitmap, W, reinterpret_cast<const float4*>(g), S,
        reinterpret_cast<float4*>(out));
  }
  return (int)cudaGetLastError();
}
