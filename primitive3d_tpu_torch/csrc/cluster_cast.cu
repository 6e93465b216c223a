// Cluster ray caster for Hopper (sm_90a): resident and stream work lists.
//
// Replaces two Pallas TPU kernels of primitive3d_tpu/kernels/raycast_kernel.py:
//   * :604 `_kernel_mxu` (cast_clusters_mxu(stream=False)), the resident
//     tier: a flat per-block list of (cluster, 256-ray chunk) pairs
//     `(c << 3) | r`, in cluster-major order;
//   * :372 `_kernel_mxu_stream` (cast_clusters_mxu(stream=True)), the stream
//     tier: one word per cluster `(c << 16) | chunk_mask`, sorted front to
//     back by a conservative entry bound, with an early exit.
// Both lists come from the cull kernel (csrc/stream_cull.cu). The TPU
// computes each visit as one K=48 double-bf16 matrix product on its matrix
// unit; here every test is plain fp32 on the CUDA cores.
//
// The function (the plain version cluster_cast_plain, bit for bit on every
// ray but those whose nearer hit is rounding noise, see the culls below):
// per ray, over the triangles of the clusters listed for its chunk, a hit
// needs the three Plücker side products and the numerator to share a sign
// bit (with edge_wildcard, an exactly-zero product agrees with any sign);
// t = num / (s0 + s1 + s2); the key is bits(|ok ? t : 3e38|) with its low
// log2(S) bits replaced by the triangle slot, so one int32 min gives the
// nearest hit and, on equal quantised t, the lowest slot (abs() keeps a -0.0
// from becoming INT_MIN, and a NaN t from a padding triangle loses to every
// finite key). Across visits the update is `tb < best` with best starting at
// max_dist, so the first visit in list order wins ties. All products and
// sums are separately rounded (__fmul_rn / __fadd_rn, no FMA contraction) in
// the order the plain PyTorch version writes them. Each ray copies its
// winner's 8-float finish row; the TPU's one-hot matrix product was only a
// way around a gather.
//
// Why no tensor cores: the contract is bit equality with a plain version
// whose every product is rounded on its own. TF32 or split-bf16 products on
// the tensor cores cannot give those bits (the TPU's double-bf16 products
// already differ from the port on a few rays), so the tests run on the fp32
// CUDA cores.
//
// What bounds it: operations, ~42 fp32 operations per ray-triangle test
// (three 6-term side products, a 4-term numerator, two adds, a division).
//
// One walk for both lists (walk_kernel, a template over the list's
// format): each warp of 32 rays walks its chunk's list on its own, with no
// barrier and no block vote. A warp loads 32 list words at a time and takes
// those of its chunk in list order. The resident list holds pairs
// `(c << 3) | r`, has no bounds and no exit: the warp visits each listed
// cluster in turn, as the TPU's `_kernel_mxu` does. The stream list holds
// words `(c << 16) | chunk_mask` with their bounds, and adds the exit below.
// The culls and the copies are the same for both.
//
// The walk, per listed cluster:
//   * early exit (stream list only): at each entry of its chunk, when
//     every lane's best <= the entry's bound, the warp stops. The list is
//     sorted by bound, a lower bound on every later cluster's entry t for
//     every ray of the chunk, so a later cluster can only win with a t
//     below its own box: the t of a test whose side products are all
//     rounding noise (a ray through a vertex, nearly in the triangle's
//     plane), which a float64 evaluation of the same row does not give. On
//     such a ray the kernel may keep a farther hit than the plain version,
//     which visits every listed cluster; raycast_kernel.cast_disputes
//     settles each one;
//   * box cull: each lane slab-tests the cluster box against its own ray,
//     and a ballot skips the cluster when no lane's ray enters it ahead of
//     its origin. The cull must never drop a cluster that holds a lane's
//     hit: the box is closed and widened by `widen` (the caller's
//     raycast_kernel.CULL_WIDEN, 2^-14) of (|o|_1 + its largest
//     coordinate), far more than the rounding of a Plücker sign test or of
//     the slab test (~2^-21 of that scale), and a NaN slab (axis-parallel
//     ray on a box plane) is the whole line. The same test
//     then picks the cluster's sub-boxes of 8 triangles
//     (MxuClusterBVH.sub_boxes) that some lane enters, and only their
//     triangles are tested. The entry t is not held against the running
//     best: a ray that lies in a triangle's plane gets num = 0 and a sign
//     test passed by rounding, so t = 0 where its box starts far ahead, and
//     the plain version keeps such a hit;
//   * each warp copies those sub-boxes' 24-float rows into its own slice
//     of shared memory (coalesced float4 loads), then every lane reads
//     each row with six broadcast float4 loads. Reading the rows through
//     L1 with warp-uniform float4 loads instead was slower on the card:
//     six 16-byte global loads per test cost more than shared-memory
//     reads. The copy is per warp and not per block, since the block's
//     warps walk different clusters;
//   * the division runs only in the lanes whose sign test passed; a failed
//     test's key is fabsf(3e38) whatever t is.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int RCHUNK = 256;            // rays per chunk
constexpr int NCH = 8;                 // chunks per 2048-ray block
constexpr int MBLOCK = RCHUNK * NCH;
constexpr int WROW = 24;               // floats per triangle row (22 + 2 pad)
constexpr int MAX_S = 256;             // largest cluster size
constexpr int SWARPS = 4;              // warps per CUDA block
constexpr int SUB = 8;                 // triangles per sub-box
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

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

// The ray's outputs: depth, sorted index and its winner's finish row.
__device__ __forceinline__ void finish(long long ray, float best, int bidx,
                                       const float* __restrict__ fin,
                                       float* __restrict__ depth,
                                       int* __restrict__ idx,
                                       float* __restrict__ fin_out) {
  depth[ray] = best;
  idx[ray] = bidx;
  if (fin_out != nullptr) {
    float4* fo = reinterpret_cast<float4*>(fin_out + ray * 8);
    if (bidx >= 0) {
      const float4* fr =
          reinterpret_cast<const float4*>(fin + (long long)bidx * 8);
      fo[0] = fr[0];
      fo[1] = fr[1];
    } else {
      fo[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      fo[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The key of one ray-triangle test: bits(|ok ? t : 3e38|) with its low
// bits replaced by the slot j. The row is in shared memory, and every lane
// reads the same address.
template <bool WILDCARD>
__device__ __forceinline__ int test_key(const float* __restrict__ row, int j,
                                        int im, float dx, float dy, float dz,
                                        float mx, float my, float mz,
                                        float ox, float oy, float oz) {
  const float4* u = reinterpret_cast<const float4*>(row);
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
  float tm = 3.0e38f;
  if (ok) tm = fabsf(__fdiv_rn(num, add(add(s0, s1), s2)));
  return (__float_as_int(tm) & ~im) | j;
}

// One axis of the box cull's slab test: the entry and exit t of [l, h]. A
// NaN is 0 * inf: the ray runs in one of the slab's planes, inside the
// closed slab for every t.
__device__ __forceinline__ void axis(float l, float h, float o, float inv,
                                     float& lo, float& hi) {
  const float a = mul(sub(l, o), inv), b = mul(sub(h, o), inv);
  const bool on = a != a || b != b;
  lo = on ? -CUDART_INF_F : fminf(a, b);
  hi = on ? CUDART_INF_F : fmaxf(a, b);
}

// Does the ray (origin o, 1 / d = inv, span = |ox| + |oy| + |oz|) enter the
// box bx, widened by `widen` of (span + its largest coordinate), ahead of
// its origin? The plain PyTorch form of this test is
// raycast_kernel._stream_box_enters.
__device__ __forceinline__ bool box_enters(const float* __restrict__ bx,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float span, float widen) {
  const float lx = __ldg(bx), ly = __ldg(bx + 1), lz = __ldg(bx + 2);
  const float hx = __ldg(bx + 3), hy = __ldg(bx + 4), hz = __ldg(bx + 5);
  const float big = fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(ly)), fabsf(lz)),
                          fmaxf(fmaxf(fabsf(hx), fabsf(hy)), fabsf(hz)));
  const float tol = mul(add(span, big), widen);
  float x0, x1, y0, y1, z0, z1;
  axis(sub(lx, tol), add(hx, tol), ox, ix, x0, x1);
  axis(sub(ly, tol), add(hy, tol), oy, iy, y0, y1);
  axis(sub(lz, tol), add(hz, tol), oz, iz, z0, z1);
  const float tmin = fmaxf(fmaxf(x0, y0), z0);
  const float tmax = fminf(fminf(x1, y1), z1);
  return tmin <= tmax && tmax >= 0.0f;
}

// A warp per 32 rays, walking its chunk's list on its own. STREAM: the
// list holds words `(c << 16) | chunk_mask` with bounds and an exit; else
// pairs `(c << 3) | r` (bounds unused).
template <bool WILDCARD, bool STREAM>
__global__ void __launch_bounds__(SWARPS * 32) walk_kernel(
    const int* __restrict__ entries, const float* __restrict__ bounds,
    const int* __restrict__ nwork, int stride,
    const float* __restrict__ boxes, const float* __restrict__ sub_boxes,
    float widen, const float* __restrict__ w, const float* __restrict__ fin,
    const float* __restrict__ rays, long long Rp, int S, float max_dist,
    float* __restrict__ depth, int* __restrict__ idx,
    float* __restrict__ fin_out, int* __restrict__ visits) {
  extern __shared__ __align__(16) float4 staged[];
  const int lane = threadIdx.x & 31;
  float4* stage = staged + (threadIdx.x >> 5) * (S * WROW / 4);
  const long long gw = (long long)blockIdx.x * SWARPS + (threadIdx.x >> 5);
  const long long ray = gw * 32 + lane;
  const int b = (int)(gw / (MBLOCK / 32));
  const int r = (int)(gw % (MBLOCK / 32)) / (RCHUNK / 32);
  const float dx = rays[ray], dy = rays[Rp + ray], dz = rays[2 * Rp + ray];
  const float mx = rays[3 * Rp + ray], my = rays[4 * Rp + ray],
              mz = rays[5 * Rp + ray];
  const float ox = rays[6 * Rp + ray], oy = rays[7 * Rp + ray],
              oz = rays[8 * Rp + ray];
  const float ix = __fdiv_rn(1.0f, dx), iy = __fdiv_rn(1.0f, dy),
              iz = __fdiv_rn(1.0f, dz);
  const float span = add(add(fabsf(ox), fabsf(oy)), fabsf(oz));
  const int im = S - 1;
  const int n = nwork[b];
  const int* wl = entries + (long long)b * stride;
  const float* bl = STREAM ? bounds + (long long)b * stride : nullptr;
  const int nsub = S >= SUB ? S / SUB : 1;  // sub-boxes per cluster
  const int per = S / nsub;                 // triangles per sub-box
  float best = max_dist;
  int bidx = -1;
  int listed = 0, tested = 0, subs_tested = 0;

  bool done = false;
  for (int e0 = 0; e0 < n && !done; e0 += 32) {
    const int e = e0 + lane;
    const int word = e < n ? __ldg(wl + e) : 0;
    const float bnd = STREAM && e < n ? __ldg(bl + e) : 0.0f;
    const bool ours = e < n && (STREAM ? ((word >> r) & 1) != 0
                                       : (word & (NCH - 1)) == r);
    unsigned mine = __ballot_sync(FULL, ours);
    while (mine != 0) {
      const int k = __ffs(mine) - 1;
      mine &= mine - 1;
      if (STREAM) {
        const float be = __shfl_sync(FULL, bnd, k);
        if (__all_sync(FULL, best <= be)) {
          done = true;
          break;
        }
      }
      const int c = __shfl_sync(FULL, word, k) >> (STREAM ? 16 : 3);
      ++listed;
      const bool in = box_enters(boxes + 6LL * c, ox, oy, oz, ix, iy, iz,
                                 span, widen);
      if (!__any_sync(FULL, in)) continue;
      ++tested;
      // the sub-boxes that some lane enters, by the same test
      unsigned subs = 0;
      for (int k = 0; k < nsub; ++k) {
        const bool sin = box_enters(sub_boxes + 6LL * (c * nsub + k), ox, oy,
                                    oz, ix, iy, iz, span, widen);
        if (__any_sync(FULL, sin)) subs |= 1u << k;
      }
      subs_tested += __popc(subs);
      // the warp's copy of those sub-boxes' rows, then broadcast reads
      const float4* src =
          reinterpret_cast<const float4*>(w + (long long)c * S * WROW);
      const int q = per * WROW / 4;  // float4s per sub-box
      for (unsigned m = subs; m != 0; m &= m - 1) {
        const int base = (__ffs(m) - 1) * q;
        for (int i = lane; i < q; i += 32) {
          stage[base + i] = __ldg(src + base + i);
        }
      }
      __syncwarp();
      const float* cw = reinterpret_cast<const float*>(stage);
      int kmin = INT_MAX;
      for (unsigned m = subs; m != 0; m &= m - 1) {
        const int j0 = (__ffs(m) - 1) * per;
#pragma unroll 4
        for (int j = j0; j < j0 + per; ++j) {
          kmin = min(kmin, test_key<WILDCARD>(cw + j * WROW, j, im, dx, dy,
                                              dz, mx, my, mz, ox, oy, oz));
        }
      }
      __syncwarp();  // every lane is done with the rows before the next copy
      const float tb = __int_as_float(kmin & ~im);
      if (tb < best) {
        best = tb;
        bidx = c * S + (kmin & im);
      }
    }
  }
  finish(ray, best, bidx, fin, depth, idx, fin_out);
  if (visits != nullptr && lane == 0) {  // the chunk's sums over its warps
    int* v = visits + 3 * (b * NCH + r);
    atomicAdd(v, listed);
    atomicAdd(v + 1, tested);
    atomicAdd(v + 2, subs_tested);
  }
}

template <bool WILDCARD, bool STREAM>
void launch(const int* work, const float* bounds, const int* nwork,
            int stride, const float* boxes, const float* sub_boxes,
            float widen, const float* w, const float* fin, const float* rays,
            long long Rp, int B, int S, float max_dist, float* depth,
            int* idx, float* fin_out, int* visits, cudaStream_t stream) {
  const int bytes = SWARPS * S * WROW * 4;  // each warp's copy of a cluster
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(walk_kernel<WILDCARD, STREAM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  walk_kernel<WILDCARD, STREAM><<<B * (MBLOCK / 32 / SWARPS), SWARPS * 32,
                                  bytes, stream>>>(
      work, bounds, nwork, stride, boxes, sub_boxes, widen, w, fin, rays, Rp,
      S, max_dist, depth, idx, fin_out, visits);
}

template <bool STREAM>
int cast(const int* work, const float* bounds, const int* n, int stride,
         const float* boxes, const float* sub_boxes, float widen,
         const float* w, const float* fin, const float* rays, long long Rp,
         int B, int S, float max_dist, int edge_wildcard, float* depth,
         int* idx, float* fin_out, int* visits, cudaStream_t stream) {
  if (S < 1 || S > MAX_S || (S & (S - 1)) != 0 || B < 1 ||
      Rp != (long long)B * MBLOCK) {
    return (int)cudaErrorInvalidValue;
  }
  if (edge_wildcard) {
    launch<true, STREAM>(work, bounds, n, stride, boxes, sub_boxes, widen, w,
                         fin, rays, Rp, B, S, max_dist, depth, idx, fin_out,
                         visits, stream);
  } else {
    launch<false, STREAM>(work, bounds, n, stride, boxes, sub_boxes, widen,
                          w, fin, rays, Rp, B, S, max_dist, depth, idx,
                          fin_out, visits, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points take the same arguments: the list (B, stride) int32
// and n (B,) int32; the bounds (B, stride) float32 (stream tier; null for
// the resident tier); the cluster boxes (C, 6) and sub-boxes
// (C, max(1, S / 8), 6) float32 and their widening for the culls; visits
// (B * 8, 3) int32, zeroed, or null: per chunk, summed over its warps, the
// list entries they reached, the clusters and the sub-boxes they tested.

// Resident tier: pairs `(c << 3) | r`, cluster-major.
extern "C" int cluster_cast_resident(
    const int* pairs, const float* bounds, const int* n, int stride,
    const float* boxes, const float* sub_boxes, float widen, const float* w,
    const float* fin, const float* rays, long long Rp, int B, int S,
    float max_dist, int edge_wildcard, float* depth, int* idx,
    float* fin_out, int* visits, cudaStream_t stream) {
  return cast<false>(pairs, bounds, n, stride, boxes, sub_boxes, widen, w,
                     fin, rays, Rp, B, S, max_dist, edge_wildcard, depth,
                     idx, fin_out, visits, stream);
}

// Stream tier: entries `(c << 16) | chunk_mask` and their bounds, sorted
// front to back.
extern "C" int cluster_cast_stream(
    const int* entries, const float* bounds, const int* n, int stride,
    const float* boxes, const float* sub_boxes, float widen, const float* w,
    const float* fin, const float* rays, long long Rp, int B, int S,
    float max_dist, int edge_wildcard, float* depth, int* idx,
    float* fin_out, int* visits, cudaStream_t stream) {
  return cast<true>(entries, bounds, n, stride, boxes, sub_boxes, widen, w,
                    fin, rays, Rp, B, S, max_dist, edge_wildcard, depth, idx,
                    fin_out, visits, stream);
}
