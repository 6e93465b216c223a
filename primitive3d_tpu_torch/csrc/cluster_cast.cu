// Cluster ray caster for Hopper (sm_90a): resident and stream work lists.
//
// Replaces two Pallas TPU kernels of primitive3d_tpu/kernels/raycast_kernel.py:
//   * :604 `_kernel_mxu` (cast_clusters_mxu(stream=False)), the resident
//     tier: a flat per-block list of (cluster, 256-ray chunk) pairs
//     `(c << 3) | r`, in cluster-major order;
//   * :372 `_kernel_mxu_stream` (cast_clusters_mxu(stream=True)), the stream
//     tier: one word per cluster `(c << 16) | chunk_mask`, sorted front to
//     back by a conservative entry bound, with an exact early exit.
// The TPU computes each visit as one K=48 double-bf16 matrix product on its
// matrix unit; here every test is plain fp32 on the CUDA cores.
//
// What bounds it on this card: operations. A visit tests S triangles
// against 256 rays, ~42 fp32 operations per test (three 6-term Plücker side
// products, a 4-term numerator, two adds and a division); the cluster data
// (S x 24 floats of Plücker rows) is read once per visit from L2 and is tiny
// beside that, so the bound is visits * S * 256 * 42 / 67 TFLOP/s.
//
// Design (simple first, no tensor cores, TMA or cp.async yet): one CUDA block
// of 256 threads per (2048-ray block b, 256-ray chunk r), one ray per thread.
// The block walks block b's work list in list order and takes the visits of
// its own chunk. For each visit it stages the cluster's S x 24-float rows in
// shared memory (one float4 copy, ~12 KB at S = 128), and every thread tests
// all S triangles, reading each row with six broadcast float4 loads. All
// products and sums are separately rounded (__fmul_rn / __fadd_rn, no FMA
// contraction) in the order the plain PyTorch version writes them, so the two
// agree bit for bit.
//
// Per test, as in the TPU kernel: a hit needs the three side products and
// the numerator to share a sign bit (with edge_wildcard, an exactly-zero
// product agrees with any sign); t = num / (s0 + s1 + s2); the key is
// bits(|ok ? t : 3e38|) with its low log2(S) bits replaced by the triangle
// slot, so one int32 min gives the nearest hit and, on equal quantised t,
// the lowest slot (abs() keeps a -0.0 from becoming INT_MIN, and a NaN t
// from a padding triangle loses to every finite key). Across visits the
// update is `tb < best` with best starting at max_dist, so the first visit
// in list order wins ties. Stream tier: every 4th entry the block checks
// whether all its rays already have best <= the entry's bound; the list is
// sorted by bound, so no later cluster can win and the chunk stops (exact,
// like the TPU kernel's convergence mask). After the loop each thread copies
// its winner's 8-float finish row directly; the TPU's one-hot matrix
// product was only a way around a gather.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RCHUNK = 256;            // rays per chunk = threads per block
constexpr int NCH = 8;                 // chunks per 2048-ray block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr int WROW = 24;               // floats per triangle row (22 + 2 pad)
constexpr int MAX_S = 256;             // largest cluster size

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ((((u0 x + u1 y) + u2 z) + u3 p) + u4 q) + u5 s, each step rounded
__device__ __forceinline__ float dot6(float u0, float u1, float u2, float u3,
                                      float u4, float u5, float x, float y,
                                      float z, float p, float q, float s) {
  float a = add(mul(u0, x), mul(u1, y));
  a = add(a, mul(u2, z));
  a = add(a, mul(u3, p));
  a = add(a, mul(u4, q));
  return add(a, mul(u5, s));
}

template <bool STREAM, bool WILDCARD>
__global__ void __launch_bounds__(RCHUNK) cluster_cast_kernel(
    const int* __restrict__ work, const float* __restrict__ bounds,
    const int* __restrict__ nwork, int stride, const float* __restrict__ w,
    const float* __restrict__ fin, const float* __restrict__ rays,
    long long Rp, int S, float max_dist, float* __restrict__ depth,
    int* __restrict__ idx, float* __restrict__ fin_out,
    int* __restrict__ visits) {
  __shared__ __align__(16) float sw[MAX_S * WROW];
  const int b = blockIdx.x / NCH;
  const int r = blockIdx.x % NCH;
  const long long ray = (long long)b * MBLOCK + r * RCHUNK + threadIdx.x;
  // rays: (9, Rp) rows d, m = o x d, o
  const float dx = rays[ray], dy = rays[Rp + ray], dz = rays[2 * Rp + ray];
  const float mx = rays[3 * Rp + ray], my = rays[4 * Rp + ray],
              mz = rays[5 * Rp + ray];
  const float ox = rays[6 * Rp + ray], oy = rays[7 * Rp + ray],
              oz = rays[8 * Rp + ray];
  const int im = S - 1;
  const int n = nwork[b];
  const int* wl = work + (long long)b * stride;
  const float* bl = STREAM ? bounds + (long long)b * stride : nullptr;
  float best = max_dist;
  int bidx = -1;
  int nvis = 0;

  for (int e = 0; e < n; ++e) {
    const int word = wl[e];
    int c;
    if (STREAM) {
      // block-uniform: every thread sees the same e and word
      if ((e & 3) == 0 && __syncthreads_and(best <= bl[e])) break;
      if (((word >> r) & 1) == 0) continue;
      c = word >> 16;
    } else {
      if ((word & (NCH - 1)) != r) continue;
      c = word >> 3;
    }
    ++nvis;
    __syncthreads();  // all threads are done with the previous cluster
    const float4* src =
        reinterpret_cast<const float4*>(w + (long long)c * S * WROW);
    float4* dst = reinterpret_cast<float4*>(sw);
    for (int i = threadIdx.x; i < S * WROW / 4; i += RCHUNK) dst[i] = src[i];
    __syncthreads();

    int kmin = INT_MAX;
#pragma unroll 2
    for (int j = 0; j < S; ++j) {
      const float4* u = reinterpret_cast<const float4*>(sw + j * WROW);
      const float4 q0 = u[0], q1 = u[1], q2 = u[2], q3 = u[3], q4 = u[4],
                   q5 = u[5];
      const float s0 = dot6(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                            dx, dy, dz, mx, my, mz);
      const float s1 = dot6(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w,
                            dx, dy, dz, mx, my, mz);
      const float s2 = dot6(q3.x, q3.y, q3.z, q3.w, q4.x, q4.y,
                            dx, dy, dz, mx, my, mz);
      float num = add(mul(q4.z, ox), mul(q4.w, oy));
      num = add(num, mul(q5.x, oz));
      num = add(num, q5.y);
      const int b0 = __float_as_int(s0), b1 = __float_as_int(s1);
      const int b2 = __float_as_int(s2), b3 = __float_as_int(num);
      bool ok;
      if (WILDCARD) {
        const int M = 0x7FFFFFFF;
        const bool nz0 = (b0 & M) != 0, nz1 = (b1 & M) != 0;
        const bool nz2 = (b2 & M) != 0, nz3 = (b3 & M) != 0;
        const bool bad = (((b0 ^ b1) < 0) && nz0 && nz1) ||
                         (((b0 ^ b2) < 0) && nz0 && nz2) ||
                         (((b0 ^ b3) < 0) && nz0 && nz3) ||
                         (((b1 ^ b2) < 0) && nz1 && nz2) ||
                         (((b1 ^ b3) < 0) && nz1 && nz3) ||
                         (((b2 ^ b3) < 0) && nz2 && nz3);
        ok = !bad;
      } else {
        ok = ((b0 ^ b1) | (b0 ^ b2) | (b0 ^ b3)) >= 0;
      }
      const float den = add(add(s0, s1), s2);
      const float t = __fdiv_rn(num, den);
      const float tm = fabsf(ok ? t : 3.0e38f);
      kmin = min(kmin, (__float_as_int(tm) & ~im) | j);
    }
    const float tb = __int_as_float(kmin & ~im);
    if (tb < best) {
      best = tb;
      bidx = c * S + (kmin & im);
    }
  }

  depth[ray] = best;
  idx[ray] = bidx;
  if (fin_out != nullptr) {
    float4* fo = reinterpret_cast<float4*>(fin_out + ray * 8);
    if (bidx >= 0) {
      const float4* fr = reinterpret_cast<const float4*>(fin + (long long)bidx * 8);
      fo[0] = fr[0];
      fo[1] = fr[1];
    } else {
      fo[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      fo[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = nvis;
}

template <bool STREAM>
int launch(const int* work, const float* bounds, const int* nwork, int stride,
           const float* w, const float* fin, const float* rays, long long Rp,
           int B, int S, float max_dist, int edge_wildcard, float* depth,
           int* idx, float* fin_out, int* visits, cudaStream_t stream) {
  if (S < 1 || S > MAX_S || (S & (S - 1)) != 0 || B < 1 ||
      Rp != (long long)B * MBLOCK) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(B * NCH), block(RCHUNK);
  if (edge_wildcard) {
    cluster_cast_kernel<STREAM, true><<<grid, block, 0, stream>>>(
        work, bounds, nwork, stride, w, fin, rays, Rp, S, max_dist, depth,
        idx, fin_out, visits);
  } else {
    cluster_cast_kernel<STREAM, false><<<grid, block, 0, stream>>>(
        work, bounds, nwork, stride, w, fin, rays, Rp, S, max_dist, depth,
        idx, fin_out, visits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Resident tier: pairs (B, stride) int32 `(c << 3) | r`, n (B,) int32.
extern "C" int cluster_cast_resident(
    const int* pairs, const int* n, int stride, const float* w,
    const float* fin, const float* rays, long long Rp, int B, int S,
    float max_dist, int edge_wildcard, float* depth, int* idx,
    float* fin_out, int* visits, cudaStream_t stream) {
  return launch<false>(pairs, nullptr, n, stride, w, fin, rays, Rp, B, S,
                       max_dist, edge_wildcard, depth, idx, fin_out, visits,
                       stream);
}

// Stream tier: entries (B, stride) int32 `(c << 16) | chunk_mask` and their
// bounds (B, stride) float32, sorted front to back; n (B,) int32.
extern "C" int cluster_cast_stream(
    const int* entries, const float* bounds, const int* n, int stride,
    const float* w, const float* fin, const float* rays, long long Rp, int B,
    int S, float max_dist, int edge_wildcard, float* depth, int* idx,
    float* fin_out, int* visits, cudaStream_t stream) {
  return launch<true>(entries, bounds, n, stride, w, fin, rays, Rp, B, S,
                      max_dist, edge_wildcard, depth, idx, fin_out, visits,
                      stream);
}
