// Work-list cull of the cluster ray caster for Hopper (sm_90a): the stream
// tier's list and the resident tier's, one CUDA block per 2048-ray block.
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package builds
// these lists in plain XLA (primitive3d_tpu/kernels/raycast_kernel.py:801
// `_interval_cull`, :840 `_ray_intervals`, :856 `_stream_entries`, :889
// `_mxu_prep`); the port's plain PyTorch version of the same functions
// (`work_lists_plain`) is a chain of some 80 elementwise launches per pass
// over (B, 8, C) float tensors, a segmented sort and gathers, and took most
// of the stream tier's cast on the card. Here the (B, 8, C) intermediates
// never reach memory.
//
// What it computes, bit for bit as the plain version does:
//   * per 256-ray chunk r of block b, the interval of its rays: amin / amax
//     of the origins and of clamp(1 / d, -1e18, 1e18) (an IEEE division);
//   * per (b, r, cluster c), the conservative slab test of that interval
//     against c's box: per axis the four differences, the eight products and
//     their min / max, the entry bound tl (max over axes) and exit bound th
//     (min over axes); the chunk is flagged when tl <= th, th >= 0,
//     tl < max_dist and the box is not degenerate (some hi > lo). Min and
//     max propagate NaN, as torch.minimum / torch.maximum do (PTX
//     min.NaN / max.NaN), so a NaN flags nothing;
//   * stream tier: per cluster the chunk mask and the bound, the least
//     max(tl, 0) over its flagged chunks (3e38 where none), a zero always
//     +0.0. Row b of the list holds the flagged clusters' words
//     (c << 16) | mask sorted by (bound, c), which is the plain version's
//     stable sort by bound, then the unflagged clusters' words c << 16 in
//     index order with bound 3e38;
//   * resident tier: the flagged pairs (c << 3) | r in cluster-major order,
//     then the unflagged pairs in index order.
//
// Design: one block of 256 threads per row b. Warp r reduces chunk r's 256
// rays into the 12-float interval (shared memory). Then each thread takes
// clusters t, t + 256, ...: it loads the box, computes all 8 chunk flags and
// the bound in registers and keeps the mask byte in shared memory. A block
// scan (ballots and warp shuffles) ranks the flagged clusters (stream) or
// pairs (resident) in index order: a second pass writes the unflagged tail
// at n_b + its rank among the unflagged and, for the resident tier, the
// flagged pairs at their rank. The stream tier's flagged (bound, c) pairs go
// to shared memory in index order and a bitonic sort over the next power of
// two above n_b puts them in (bound, c) order: the keys are distinct, so
// the sort equals a stable sort by bound. The sort is in the kernel and not
// a library call so that the whole list is one launch, with no host sync
// to size a compacted buffer and no sort of the unflagged tail.
//
// What bounds it: operations. 8 * C slab tests of ~87 fp32 operations per
// row (26 per axis, the combines and the flag), beside which the rays read
// once (24 bytes each) and the lists written once (8 bytes per cluster per
// row) are small.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RCHUNK = 256;
constexpr int NCH = 8;  // chunks per row = warps per block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr float BIG = 3.0e38f;       // the bound of an unflagged cluster
constexpr float IV_CLIP = 1.0e18f;   // |1 / d| clip of the intervals
constexpr unsigned short NO_CLUSTER = 0xffff;

__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Exclusive scan of v over the block, in thread order; *total gets the sum.
// Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, s);
    if (lane >= s) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int x = warp_sums[k];
    before += k < warp ? x : 0;
    sum += x;
  }
  __syncthreads();  // warp_sums may be written again by the next call
  *total = sum;
  return before + incl - v;
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS) cull_kernel(
    const float* __restrict__ rays, long long Rp,
    const float* __restrict__ boxes, int C, int P, float max_dist,
    int* __restrict__ n_out, int* __restrict__ work,
    float* __restrict__ sbound) {
  extern __shared__ __align__(16) unsigned char smem[];
  // stream: sort keys, P floats then P cluster ids; both tiers: mask bytes
  float* sb = reinterpret_cast<float*>(smem);
  unsigned short* sc = reinterpret_cast<unsigned short*>(smem + 4 * P);
  unsigned char* m8 = smem + 6 * P;
  __shared__ float rint[NCH][12];
  __shared__ int warp_sums[WARPS];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = STREAM ? C : 8LL * C;

  // -- chunk intervals: warp r reduces the 256 rays of chunk r -----------
  {
    float lo[6], hi[6];
    for (int k = 0; k < RCHUNK / 32; ++k) {
      const long long i = (long long)b * MBLOCK + warp * RCHUNK + k * 32 + lane;
      float v[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = rays[(6 + a) * Rp + i];  // origin
        const float iv = __fdiv_rn(1.0f, rays[a * Rp + i]);
        v[3 + a] = nmin(nmax(iv, -IV_CLIP), IV_CLIP);
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        lo[q] = k ? nmin(lo[q], v[q]) : v[q];
        hi[q] = k ? nmax(hi[q], v[q]) : v[q];
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        lo[q] = nmin(lo[q], __shfl_xor_sync(FULL, lo[q], s));
        hi[q] = nmax(hi[q], __shfl_xor_sync(FULL, hi[q], s));
      }
    }
    if (lane == 0) {
      // [oxlo, oxhi, oylo, oyhi, ozlo, ozhi, ivxlo, ivxhi, ..., ivzhi]
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        rint[warp][2 * a] = lo[a];
        rint[warp][2 * a + 1] = hi[a];
        rint[warp][6 + 2 * a] = lo[3 + a];
        rint[warp][7 + 2 * a] = hi[3 + a];
      }
    }
  }
  __syncthreads();

  // -- pass 1: flags and bounds; stream: flagged (bound, c) in index order
  int count = 0;  // flagged clusters (stream) or pairs (resident) so far
  for (int c0 = 0; c0 < C; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    unsigned mask = 0;
    float bound = BIG;
    if (c < C) {
      float L[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) L[q] = boxes[6LL * c + q];
      const bool nondeg = L[3] > L[0] || L[4] > L[1] || L[5] > L[2];
#pragma unroll 1
      for (int r = 0; r < NCH; ++r) {
        float tl = 0.0f, th = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float olo = rint[r][2 * a], ohi = rint[r][2 * a + 1];
          const float ivl = rint[r][6 + 2 * a], ivh = rint[r][7 + 2 * a];
          const float d00 = sub(L[a], ohi), d01 = sub(L[a], olo);
          const float d10 = sub(L[a + 3], ohi), d11 = sub(L[a + 3], olo);
          const float p[8] = {mul(d00, ivl), mul(d00, ivh), mul(d01, ivl),
                              mul(d01, ivh), mul(d10, ivl), mul(d10, ivh),
                              mul(d11, ivl), mul(d11, ivh)};
          float nr = p[0], fr = p[0];
#pragma unroll
          for (int q = 1; q < 8; ++q) {
            nr = nmin(nr, p[q]);
            fr = nmax(fr, p[q]);
          }
          tl = a ? nmax(tl, nr) : nr;
          th = a ? nmin(th, fr) : fr;
        }
        if (nondeg && tl <= th && th >= 0.0f && tl < max_dist) {
          mask |= 1u << r;
          bound = fminf(bound, tl > 0.0f ? tl : 0.0f);  // no NaN here
        }
      }
      m8[c] = (unsigned char)mask;
    }
    int tile;
    const int v = STREAM ? (mask != 0) : __popc(mask);
    const int before = block_scan(v, warp_sums, &tile);
    if (STREAM && mask != 0) {
      sb[count + before] = bound;
      sc[count + before] = (unsigned short)c;
    }
    count += tile;
  }
  const int n = count;
  __syncthreads();  // m8 complete

  // -- pass 2: the unflagged tail; resident: the flagged pairs too -------
  count = 0;
  for (int c0 = 0; c0 < C; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    const unsigned mask = c < C ? m8[c] : 0u;
    int tile;
    const int v = STREAM ? (mask != 0) : __popc(mask);
    const int flagged_before = count + block_scan(v, warp_sums, &tile);
    if (c < C) {
      int* row = work + (long long)b * stride;
      if (STREAM) {
        if (mask == 0) {
          const long long pos = n + (c - flagged_before);
          row[pos] = c << 16;
          sbound[(long long)b * stride + pos] = BIG;
        }
      } else {
#pragma unroll
        for (int r = 0; r < NCH; ++r) {
          const int pid = c * NCH + r;
          const int rank = __popc(mask & ((1u << r) - 1u));
          const long long pos = ((mask >> r) & 1u)
                                    ? flagged_before + rank
                                    : n + (pid - (flagged_before + rank));
          row[pos] = pid;
        }
      }
    }
    count += tile;
  }

  if (STREAM) {
    // -- bitonic sort of the n flagged (bound, c) pairs -----------------
    int m = 1;
    while (m < n) m <<= 1;
    for (int i = n + threadIdx.x; i < m; i += THREADS) {
      sb[i] = CUDART_INF_F;
      sc[i] = NO_CLUSTER;
    }
    __syncthreads();
    for (int k = 2; k <= m; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < m; i += THREADS) {
          const int l = i ^ j;
          if (l > i) {
            const float bi = sb[i], bl = sb[l];
            const unsigned short ci = sc[i], cl = sc[l];
            const bool gt = bi > bl || (bi == bl && ci > cl);
            if (gt == ((i & k) == 0)) {
              sb[i] = bl;
              sb[l] = bi;
              sc[i] = cl;
              sc[l] = ci;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = sc[i];
      work[(long long)b * stride + i] = (c << 16) | m8[c];
      sbound[(long long)b * stride + i] = sb[i];
    }
  }
  if (threadIdx.x == 0) n_out[b] = n;
}

}  // namespace

// rays (9, Rp) float32 rows [d; o x d; o], Rp = B * 2048; boxes (C, 6)
// float32. Stream tier (stream != 0): work (B, C) int32 entries and sbound
// (B, C) float32. Resident tier: work (B, 8 C) int32 pairs, sbound unused.
// n (B,) int32. Returns cudaGetLastError() after the launch.
extern "C" int stream_cull(const float* rays, long long Rp, int B,
                           const float* boxes, int C, float max_dist,
                           int stream, int* n, int* work, float* sbound,
                           cudaStream_t st) {
  if (B < 1 || C < 1 || Rp != (long long)B * MBLOCK ||
      (stream && C > 32767)) {
    return (int)cudaErrorInvalidValue;
  }
  int P = 0;
  if (stream) {
    P = 1;
    while (P < C) P <<= 1;
  }
  const size_t bytes = 6 * (size_t)P + (size_t)C;
  cudaError_t err;
  if (stream) {
    err = cudaFuncSetAttribute(cull_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    cull_kernel<true><<<B, THREADS, bytes, st>>>(rays, Rp, boxes, C, P,
                                                  max_dist, n, work, sbound);
  } else {
    err = cudaFuncSetAttribute(cull_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    cull_kernel<false><<<B, THREADS, bytes, st>>>(rays, Rp, boxes, C, P,
                                                   max_dist, n, work, sbound);
  }
  return (int)cudaGetLastError();
}
