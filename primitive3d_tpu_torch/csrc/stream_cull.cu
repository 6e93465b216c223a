// Work-list cull of the cluster ray caster for Hopper (sm_90a): the stream
// tier's list and the resident tier's, one CUDA block per 2048-ray block.
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package builds
// these lists in plain XLA (primitive3d_tpu/kernels/raycast_kernel.py:801
// `_interval_cull`, :840 `_ray_intervals`, :856 `_stream_entries`, :889
// `_mxu_prep`); the port's plain PyTorch version of the same functions
// (`work_lists_plain`) is a chain of some 80 elementwise launches per pass
// over (B, 8, C) float tensors, a segmented sort and gathers. Here the
// (B, 8, C) intermediates never reach memory.
//
// What it computes, bit for bit as the plain version does:
//   * per 256-ray chunk r of block b, the interval of its rays: amin / amax
//     of the origins and of clamp(1 / d, -1e18, 1e18) (an IEEE division);
//   * per (b, r, cluster c), the conservative slab test of that interval
//     against c's box: per axis the four differences L - o, the eight
//     products with the inverse-direction bounds and their min (nr) and max
//     (fr), the entry bound tl = max over axes of nr and the exit bound
//     th = min over axes of fr; the chunk is flagged when tl <= th,
//     th >= 0, tl < max_dist and the box is not degenerate (some hi > lo).
//     Min and max propagate NaN (PTX min.NaN / max.NaN, as torch.minimum /
//     torch.maximum), so a NaN flags nothing;
//   * stream tier: per cluster the chunk mask and the bound, the least
//     max(tl, 0) over its flagged chunks (3e38 where none), a zero always
//     +0.0. Row b of the list holds the flagged clusters' words
//     (c << 16) | mask sorted by (bound, c), which is the plain version's
//     stable sort by bound, then the unflagged clusters' words c << 16 in
//     index order with bound 3e38;
//   * resident tier: the flagged pairs (c << 3) | r in cluster-major order,
//     then the unflagged pairs in index order.
//
// What bounds it: operations, 8 * C slab tests per row beside which the
// rays (read once, 24 bytes each) and the lists (written once, 8 bytes per
// cluster per row) are few bytes. The plain test costs 87 fp32 operations,
// none of which fuses into an FMA.
//
// Four products, not eight, with the same bits. Per axis let
//   dmin = min(L0, L1) - ohi and dmax = max(L0, L1) - olo.
// Subtraction and multiplication round monotonically, so dmin is the least
// of the four rounded differences and dmax the greatest, and over the box
// [dmin, dmax] x [ivl, ivh] a product is least and greatest at corners: the
// least of the eight rounded products is the rounded product of the corner
// whose exact product is least, which is the least of the four rounded
// corner products dmin * ivl, dmin * ivh, dmax * ivl, dmax * ivh, and the
// same for the greatest. The signs of dmin, dmax, ivl and ivh say which
// corners those are; taking min and max over the four corners makes that
// choice without a select, at no more operations. 12 operations per axis
// instead of 26; 45 per cell instead of 87. The argument needs every value
// to be ordered (not NaN) and no product to be 0 * inf:
//   * NaN. A chunk is "safe" when its 12 interval values are finite and
//     neither inverse bound is 0. Then a difference is NaN only when a box
//     coordinate is NaN (inf - finite is inf), and a product only when its
//     difference is: nmin / nmax carry such a NaN into dmin and dmax and
//     into all four corners, so the chunk is unflagged on both paths.
//     Every other chunk (an infinite or NaN origin or direction bound, or
//     an inverse bound of 0, which needs d = +-inf) takes the plain eight
//     products, the same operations as the plain version.
//   * Overflow. L - o may round to +-inf; rounding to infinity is
//     monotone too, and with a safe chunk no product is 0 * inf.
//   * Signed zeros. The corners may give -0.0 where the eight products
//     give +0.0 or the reverse. tl and th reach the outputs only through
//     tl <= th, th >= 0, tl < max_dist and the bound max(tl, 0) written as
//     tl > 0 ? tl : +0.0, none of which sees a zero's sign.
//   * Degenerate boxes (hi == lo, the point triangles of padding) are
//     never flagged, on both paths.
// tests/test_torch_cuda.py holds the kernel to the plain version on
// chunks that straddle zero, zero direction components, boxes at +-1e37,
// degenerate boxes, rows with nothing and with everything flagged.
//
// Design: one block of 256 threads per row b.
//   1. Warp r reduces chunk r's 256 rays into its interval (shared memory,
//      one float4 per axis) and its safe flag.
//   2. Pass 1: warp w takes a contiguous range of clusters, a lane per
//      cluster: it loads the box and tests all 8 chunks unrolled (8
//      independent chains), keeps the mask byte in shared memory and, for
//      the stream tier, appends the flagged (bound, c) keys at slots taken
//      with one shared atomic per 32 clusters (any order: the sort orders
//      them). One block barrier.
//   3. Pass 2: the row's n and each warp's flagged count before its range
//      give every cluster's rank with ballots, prefix popcounts and warp
//      scans, no block barrier: the unflagged tail (both tiers) and the
//      resident tier's flagged pairs go straight to their slots.
//   4. Stream tier: the n keys are distinct, so any correct sort equals the
//      plain version's stable sort. Up to 256 keys each thread ranks one
//      key against all n (no barrier) and writes it at its rank; past that,
//      a bitonic network with ascending comparators only (the first step of
//      each merge compares i with i ^ (k - 1)), which leaves the virtual
//      +inf keys past n where they are, so nothing is padded.
// The dynamic shared memory (7 C bytes for the stream tier, C for the
// resident) is set once per size, not per launch.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RCHUNK = 256;
constexpr int NCH = 8;  // chunks per row = warps per block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr float BIG = 3.0e38f;       // the bound of an unflagged cluster
constexpr float IV_CLIP = 1.0e18f;   // |1 / d| clip of the intervals
constexpr int RANK_MAX = THREADS;    // rows of up to this many keys: rank

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

// (bound, c) < (bound', c')
__device__ __forceinline__ bool key_less(float b, unsigned short c, float b2,
                                         unsigned short c2) {
  return b < b2 || (b == b2 && c < c2);
}

struct Box {
  float lo[3], hi[3];    // L0, L1 per axis
  float mn[3], mx[3];    // min(L0, L1), max(L0, L1), NaN kept
};

// the slab test of one chunk's interval (per axis {olo, ohi, ivl, ivh})
// against a box: (tl, th)
template <bool SAFE>
__device__ __forceinline__ void slab(const Box& bx, const float4* iv,
                                     float& tl, float& th) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 q = iv[a];  // x olo, y ohi, z ivl, w ivh
    float nr, fr;
    if (SAFE) {  // the four corners of [dmin, dmax] x [ivl, ivh]
      const float dmin = sub(bx.mn[a], q.y), dmax = sub(bx.mx[a], q.x);
      const float p0 = mul(dmin, q.z), p1 = mul(dmin, q.w);
      const float p2 = mul(dmax, q.z), p3 = mul(dmax, q.w);
      nr = nmin(nmin(p0, p1), nmin(p2, p3));
      fr = nmax(nmax(p0, p1), nmax(p2, p3));
    } else {  // the plain version's eight products, in its order
      const float d00 = sub(bx.lo[a], q.y), d01 = sub(bx.lo[a], q.x);
      const float d10 = sub(bx.hi[a], q.y), d11 = sub(bx.hi[a], q.x);
      const float p[8] = {mul(d00, q.z), mul(d00, q.w), mul(d01, q.z),
                          mul(d01, q.w), mul(d10, q.z), mul(d10, q.w),
                          mul(d11, q.z), mul(d11, q.w)};
      nr = p[0];
      fr = p[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        nr = nmin(nr, p[k]);
        fr = nmax(fr, p[k]);
      }
    }
    tl = a ? nmax(tl, nr) : nr;
    th = a ? nmin(th, fr) : fr;
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS) cull_kernel(
    const float* __restrict__ rays, long long Rp,
    const float* __restrict__ boxes, int C, float max_dist,
    int* __restrict__ n_out, int* __restrict__ work,
    float* __restrict__ sbound) {
  extern __shared__ __align__(16) unsigned char smem[];
  // stream: the flagged keys, C bounds then C cluster ids; both: masks
  float* kb = reinterpret_cast<float*>(smem);
  unsigned short* kc =
      reinterpret_cast<unsigned short*>(smem + (STREAM ? 4 * C : 0));
  unsigned char* m8 = smem + (STREAM ? 6 * C : 0);
  __shared__ float4 rint[NCH][3];
  __shared__ int warp_n[WARPS];
  __shared__ int n_keys;
  __shared__ unsigned safe_chunks;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = STREAM ? C : 8LL * C;
  int* row = work + (long long)b * stride;
  float* brow = STREAM ? sbound + (long long)b * stride : nullptr;
  if (threadIdx.x == 0) {
    n_keys = 0;
    safe_chunks = 0;
  }
  __syncthreads();

  // -- 1. chunk intervals: warp r reduces the 256 rays of chunk r ---------
  {
    // all 48 loads of a lane first, so that they are in flight together
    constexpr int K = RCHUNK / 32;
    float raw[K][6];
    const long long i0 = (long long)b * MBLOCK + warp * RCHUNK + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        raw[k][a] = __ldg(rays + (6 + a) * Rp + i0 + 32 * k);  // origin
        raw[k][3 + a] = __ldg(rays + a * Rp + i0 + 32 * k);    // direction
      }
    }
    float lo[6], hi[6];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = raw[k][a];
        const float iv = __fdiv_rn(1.0f, raw[k][3 + a]);
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
      bool safe = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        rint[warp][a] = make_float4(lo[a], hi[a], lo[3 + a], hi[3 + a]);
        safe = safe && isfinite(lo[a]) && isfinite(hi[a]) &&
               isfinite(lo[3 + a]) && isfinite(hi[3 + a]) &&
               lo[3 + a] != 0.0f && hi[3 + a] != 0.0f;
      }
      if (safe) atomicOr(&safe_chunks, 1u << warp);
    }
  }
  __syncthreads();

  // -- 2. pass 1: a lane per cluster, all 8 chunks -------------------------
  const int per = (C + WARPS - 1) / WARPS;
  const int c_lo = min(C, warp * per), c_hi = min(C, c_lo + per);
  const unsigned safe = safe_chunks;
  int mine = 0;  // flagged clusters (stream) or pairs (resident) of the lane
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + lane;
    unsigned mask = 0;
    float bound = BIG;
    if (c < c_hi) {
      Box bx;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        bx.lo[a] = boxes[6LL * c + a];
        bx.hi[a] = boxes[6LL * c + 3 + a];
        bx.mn[a] = nmin(bx.lo[a], bx.hi[a]);
        bx.mx[a] = nmax(bx.lo[a], bx.hi[a]);
      }
      const bool nondeg =
          bx.hi[0] > bx.lo[0] || bx.hi[1] > bx.lo[1] || bx.hi[2] > bx.lo[2];
#pragma unroll
      for (int r = 0; r < NCH; ++r) {
        float tl, th;
        if (safe >> r & 1u) {
          slab<true>(bx, rint[r], tl, th);
        } else {
          slab<false>(bx, rint[r], tl, th);
        }
        if (nondeg && tl <= th && th >= 0.0f && tl < max_dist) {
          mask |= 1u << r;
          bound = fminf(bound, tl > 0.0f ? tl : 0.0f);  // no NaN here
        }
      }
      m8[c] = (unsigned char)mask;
    }
    if (STREAM) {
      const unsigned bal = __ballot_sync(FULL, mask != 0);
      int base = 0;
      if (lane == 0 && bal) base = atomicAdd(&n_keys, __popc(bal));
      base = __shfl_sync(FULL, base, 0);
      if (mask) {
        const int slot = base + __popc(bal & ((1u << lane) - 1u));
        kb[slot] = bound;
        kc[slot] = (unsigned short)c;
      }
      mine += mask != 0;
    } else {
      mine += __popc(mask);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) mine += __shfl_xor_sync(FULL, mine, s);
  if (lane == 0) warp_n[warp] = mine;
  __syncthreads();  // masks, keys and warp counts complete

  // -- 3. pass 2: ranks by ballots and warp scans; the tail, the pairs -----
  int n = 0, before = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    before += k < warp ? warp_n[k] : 0;
    n += warp_n[k];
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < c_hi;
    const unsigned mask = live ? m8[c] : 0u;
    if (STREAM) {
      const unsigned bal = __ballot_sync(FULL, mask != 0);
      const int flagged_before = before + __popc(bal & ((1u << lane) - 1u));
      if (live && mask == 0) {
        const int pos = n + (c - flagged_before);
        row[pos] = c << 16;
        brow[pos] = BIG;
      }
      before += __popc(bal);
    } else {
      const int v = __popc(mask);
      int incl = v;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, s);
        if (lane >= s) incl += u;
      }
      const int flagged_before = before + incl - v;  // pairs before c
      if (live) {
#pragma unroll
        for (int r = 0; r < NCH; ++r) {
          const int pid = c * NCH + r;
          const int rank = flagged_before + __popc(mask & ((1u << r) - 1u));
          row[(mask >> r) & 1u ? rank : n + (pid - rank)] = pid;
        }
      }
      before += __shfl_sync(FULL, incl, 31);
    }
  }

  // -- 4. stream tier: the n flagged keys in (bound, c) order --------------
  if (STREAM) {
    if (n <= RANK_MAX) {
      if ((int)threadIdx.x < n) {
        const float mb = kb[threadIdx.x];
        const unsigned short mc = kc[threadIdx.x];
        int rank = 0;
        for (int i = 0; i < n; ++i) rank += key_less(kb[i], kc[i], mb, mc);
        row[rank] = ((int)mc << 16) | m8[mc];
        brow[rank] = mb;
      }
    } else {
      int m = 1;
      while (m < n) m <<= 1;
      for (int k = 2; k <= m; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = threadIdx.x; i < m; i += THREADS) {
            // comparator (i, l), i < l: the smaller key to i
            const int l = j == (k >> 1) ? i ^ (k - 1) : i ^ j;
            if (l > i && l < n) {
              const float bi = kb[i], bl = kb[l];
              const unsigned short ci = kc[i], cl = kc[l];
              if (key_less(bl, cl, bi, ci)) {
                kb[i] = bl;
                kb[l] = bi;
                kc[i] = cl;
                kc[l] = ci;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int c = kc[i];
        row[i] = (c << 16) | m8[c];
        brow[i] = kb[i];
      }
    }
  }
  if (threadIdx.x == 0) n_out[b] = n;
}

// dynamic shared memory each instance may take, raised once per size
int g_smem_set[2] = {48 * 1024, 48 * 1024};

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
      (stream && C > 32767) || (!stream && C > (1 << 27))) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = stream ? 7 * C : C;
  const void* fn = stream ? (const void*)cull_kernel<true>
                          : (const void*)cull_kernel<false>;
  int& set = g_smem_set[stream ? 1 : 0];
  if (bytes > set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    set = bytes;
  }
  if (stream) {
    cull_kernel<true><<<B, THREADS, bytes, st>>>(rays, Rp, boxes, C, max_dist,
                                                  n, work, sbound);
  } else {
    cull_kernel<false><<<B, THREADS, bytes, st>>>(rays, Rp, boxes, C,
                                                   max_dist, n, work, sbound);
  }
  return (int)cudaGetLastError();
}
