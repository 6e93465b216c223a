// Scalar-broadcast cluster ray caster for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of primitive3d_tpu/kernels/raycast_kernel.py,
// the cluster caster's tier for meshes past the stream tier's 15-bit cluster
// id (32767 clusters):
//   * :45 `_kernel_ordered` (cast_clusters(ordered=True)): each 1024-ray block
//     walks the clusters in its own front-to-back order, 32 to a group, with
//     a second cull over each flagged cluster's sub-boxes of 8 triangles and
//     an early exit once every ray's best hit is nearer than the next group's
//     conservative entry bound;
//   * :219 `_kernel` (cast_clusters(ordered=False)): every group in index
//     order, the cluster cull only, all S triangles of a flagged cluster, no
//     exit.
//
// What bounds it on this card: operations. Every ray of a block runs every
// slab test of every group the block walks (~30 fp32 operations each) and
// every triangle test of the sub-boxes (or clusters) the block flags (~40).
// The data read per group, 32 boxes and the order words, is shared by the
// block's 1024 rays, so bytes are small beside that. The kernel writes the
// walk's counts per block (groups walked, clusters flagged, triangles
// tested) so that the caller can count those operations.
//
// Design (simple first): one CUDA block of 1024 threads per 1024-ray block,
// one ray per thread, as the TPU's (8, 128) tiles hold one ray per lane.
// The TPU keeps `order` (B, C) and `bound` (B, G) in SMEM by scalar prefetch;
// past 10^5 clusters they are 10^8 bytes, so here they stay in device memory
// and the block reads one order word per cluster it culls (the same address
// in every thread: one broadcast load). The TPU's per-group SMEM flags become
// block-wide votes: each thread culls the group's 32 boxes with the best hit
// it had at the group's start, sets one bit per useful box, and one
// __reduce_or_sync per warp plus one __syncthreads over a shared word per
// warp ORs the masks of the block. Flagged clusters are then taken in group
// order, each with a second vote over its S/8 sub-boxes (best at the
// cluster's start), and their triangles in slot order; the winner is taken
// with a strict t < best, so the first visit wins a tie. The early exit is
// __syncthreads_and(best <= bound[blk, g]) before each group.
//
// Rounding: every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction), 3-term sums left
// to right, in the order of the JAX expressions, and 1/x is an IEEE
// division, so the kernel equals its plain PyTorch version bit for bit. The
// slab test's min / max propagate NaN as jnp.minimum / torch.minimum do: an
// axis-parallel ray whose origin lies on a box plane gives 0 * inf = NaN,
// and the box is culled (CUDA's fminf / fmaxf would drop the NaN and keep
// it).
#include <cuda_runtime.h>

namespace {

constexpr int RB = 1024;       // rays per block = threads per block
constexpr int NWARP = RB / 32;
constexpr int GROUP = 32;      // clusters per cull group (one bit each)
constexpr int SUB = 8;         // triangles per sub-box
constexpr int MAX_NSUB = 32;   // sub-boxes per cluster (one bit each)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// NaN-propagating min / max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // origin, direction, 1 / d
};

// Slab test of box [lo xyz, hi xyz]: does the ray enter it, ahead of its
// origin, nearer than best?
__device__ __forceinline__ bool useful(const float* __restrict__ b,
                                       const Ray& r, float best) {
  const float tx0 = mul(sub(__ldg(b + 0), r.ox), r.ix);
  const float tx1 = mul(sub(__ldg(b + 3), r.ox), r.ix);
  const float ty0 = mul(sub(__ldg(b + 1), r.oy), r.iy);
  const float ty1 = mul(sub(__ldg(b + 4), r.oy), r.iy);
  const float tz0 = mul(sub(__ldg(b + 2), r.oz), r.iz);
  const float tz1 = mul(sub(__ldg(b + 5), r.oz), r.iz);
  const float tmin =
      pmax(pmax(pmin(tx0, tx1), pmin(ty0, ty1)), pmin(tz0, tz1));
  const float tmax =
      pmin(pmin(pmax(tx0, tx1), pmax(ty0, ty1)), pmax(tz0, tz1));
  return tmin <= tmax && tmax >= 0.0f && tmin < best;
}

// Möller-Trumbore against one triangle row [a, e1 = b - a, e2 = c - a];
// takes the hit if t < best.
__device__ __forceinline__ void triangle(const float* __restrict__ p,
                                         const Ray& r, float& best,
                                         int& bidx, int id) {
  const float ax = __ldg(p + 0), ay = __ldg(p + 1), az = __ldg(p + 2);
  const float e1x = __ldg(p + 3), e1y = __ldg(p + 4), e1z = __ldg(p + 5);
  const float e2x = __ldg(p + 6), e2y = __ldg(p + 7), e2z = __ldg(p + 8);
  const float hx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float hy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float hz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = add(add(mul(e1x, hx), mul(e1y, hy)), mul(e1z, hz));
  const float f = __fdiv_rn(1.0f, det == 0.0f ? 1e-30f : det);
  const float sx = sub(r.ox, ax), sy = sub(r.oy, ay), sz = sub(r.oz, az);
  const float u = mul(f, add(add(mul(sx, hx), mul(sy, hy)), mul(sz, hz)));
  const float qx = sub(mul(sy, e1z), mul(sz, e1y));
  const float qy = sub(mul(sz, e1x), mul(sx, e1z));
  const float qz = sub(mul(sx, e1y), mul(sy, e1x));
  const float v =
      mul(f, add(add(mul(r.dx, qx), mul(r.dy, qy)), mul(r.dz, qz)));
  const float t = mul(f, add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)));
  if (det != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
      add(u, v) <= 1.0f && t >= 0.0f && t < best) {
    best = t;
    bidx = id;
  }
}

// OR of m over the block. Two alternating buffers: a warp can write the
// next vote's word only after every warp has passed this vote's barrier,
// i.e. after every warp has read this vote's words.
__device__ __forceinline__ unsigned block_or(unsigned m,
                                             unsigned (*buf)[NWARP],
                                             int& parity) {
  m = __reduce_or_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) buf[parity][threadIdx.x >> 5] = m;
  __syncthreads();
  unsigned r = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) r |= buf[parity][w];
  parity ^= 1;
  return r;
}

template <bool ORDERED>
__global__ void __launch_bounds__(RB) cluster_scalar_kernel(
    const int* __restrict__ order, const float* __restrict__ gbound,
    const float* __restrict__ boxes, const float* __restrict__ sub_boxes,
    const float* __restrict__ tri, const float* __restrict__ rays,
    long long Rp, int C, int S, float max_dist, float* __restrict__ depth,
    int* __restrict__ idx, int* __restrict__ counts) {
  __shared__ unsigned vote[2][NWARP];
  int parity = 0;
  const int blk = blockIdx.x;
  const long long ray = (long long)blk * RB + threadIdx.x;
  // rays: (6, Rp) rows ox, oy, oz, dx, dy, dz
  Ray r;
  r.ox = rays[ray];
  r.oy = rays[Rp + ray];
  r.oz = rays[2 * Rp + ray];
  r.dx = rays[3 * Rp + ray];
  r.dy = rays[4 * Rp + ray];
  r.dz = rays[5 * Rp + ray];
  r.ix = __fdiv_rn(1.0f, r.dx);
  r.iy = __fdiv_rn(1.0f, r.dy);
  r.iz = __fdiv_rn(1.0f, r.dz);
  const int G = (C + GROUP - 1) / GROUP;
  const int nsub = S / SUB;
  const int* ord = ORDERED ? order + (long long)blk * C : nullptr;
  const float* gb = ORDERED ? gbound + (long long)blk * G : nullptr;
  float best = max_dist;
  int bidx = -1;
  int ngroups = 0, nclusters = 0, ntris = 0;

  for (int g = 0; g < G; ++g) {
    // converged: every ray's best is nearer than the group's entry bound
    if (ORDERED && __syncthreads_and(best <= __ldg(gb + g))) break;
    ++ngroups;
    const int base = g * GROUP;
    const int nj = min(GROUP, C - base);
    unsigned mask = 0;
    for (int j = 0; j < nj; ++j) {
      const int c = ORDERED ? __ldg(ord + base + j) : base + j;
      if (useful(boxes + (long long)c * 6, r, best)) mask |= 1u << j;
    }
    unsigned flags = block_or(mask, vote, parity);
    nclusters += __popc(flags);
    while (flags != 0) {
      const int j = __ffs(flags) - 1;
      flags &= flags - 1;
      const int c = ORDERED ? __ldg(ord + base + j) : base + j;
      const float* tc = tri + (long long)c * S * 9;
      if (ORDERED) {
        const float* sb = sub_boxes + (long long)c * nsub * 6;
        unsigned sm = 0;
        for (int s = 0; s < nsub; ++s) {
          if (useful(sb + s * 6, r, best)) sm |= 1u << s;
        }
        unsigned sflags = block_or(sm, vote, parity);
        ntris += SUB * __popc(sflags);
        while (sflags != 0) {
          const int s = __ffs(sflags) - 1;
          sflags &= sflags - 1;
          for (int m = s * SUB; m < s * SUB + SUB; ++m) {
            triangle(tc + m * 9, r, best, bidx, c * S + m);
          }
        }
      } else {
        ntris += S;
        for (int m = 0; m < S; ++m) {
          triangle(tc + m * 9, r, best, bidx, c * S + m);
        }
      }
    }
  }

  depth[ray] = best;
  idx[ray] = bidx;
  if (counts != nullptr && threadIdx.x == 0) {
    counts[blk * 3 + 0] = ngroups;
    counts[blk * 3 + 1] = nclusters;
    counts[blk * 3 + 2] = ntris;
  }
}

template <bool ORDERED>
int launch(const int* order, const float* gbound, const float* boxes,
           const float* sub_boxes, const float* tri, const float* rays,
           long long Rp, int B, int C, int S, float max_dist, float* depth,
           int* idx, int* counts, cudaStream_t stream) {
  if (B < 1 || C < 1 || S < 1 || Rp != (long long)B * RB ||
      (long long)C * S > 0x7FFFFFFFLL ||
      (ORDERED && (S % SUB != 0 || S / SUB > MAX_NSUB))) {
    return (int)cudaErrorInvalidValue;
  }
  cluster_scalar_kernel<ORDERED><<<B, RB, 0, stream>>>(
      order, gbound, boxes, sub_boxes, tri, rays, Rp, C, S, max_dist, depth,
      idx, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Ordered walk: order (B, C) int32, gbound (B, ceil(C / 32)) float32, boxes
// (C, 6), sub_boxes (C, S / 8, 6), tri (C, S, 9), rays (6, Rp) with
// Rp = B * 1024; depth (Rp,) float32, idx (Rp,) int32 sorted-triangle index;
// counts (B, 3) int32 or null.
extern "C" int cluster_scalar_ordered(
    const int* order, const float* gbound, const float* boxes,
    const float* sub_boxes, const float* tri, const float* rays, long long Rp,
    int B, int C, int S, float max_dist, float* depth, int* idx, int* counts,
    cudaStream_t stream) {
  return launch<true>(order, gbound, boxes, sub_boxes, tri, rays, Rp, B, C, S,
                      max_dist, depth, idx, counts, stream);
}

// Index-order walk, cluster cull only: the same arrays without order,
// bounds and sub-boxes.
extern "C" int cluster_scalar(const float* boxes, const float* tri,
                              const float* rays, long long Rp, int B, int C,
                              int S, float max_dist, float* depth, int* idx,
                              int* counts, cudaStream_t stream) {
  return launch<false>(nullptr, nullptr, boxes, nullptr, tri, rays, Rp, B, C,
                       S, max_dist, depth, idx, counts, stream);
}
