// Scalar-tier cluster ray caster for Hopper (sm_90a): one warp per ray,
// walking a 32-wide box tree over the clusters, one lane per child.
//
// Replaces two Pallas TPU kernels of primitive3d_tpu/kernels/raycast_kernel.py,
// the cluster caster's tier for meshes past the stream tier's 15-bit cluster
// id (32767 clusters):
//   * :45 `_kernel_ordered` (cast_clusters(ordered=True)): the cluster cull,
//     then a second cull over each entered cluster's sub-boxes of 8
//     triangles;
//   * :219 `_kernel` (cast_clusters(ordered=False)): the cluster cull only,
//     then all S triangles of an entered cluster.
// The TPU kernels walk the clusters in lock-step for a block of 1024 rays,
// because a TPU keeps rays in (8, 128) vector tiles and decides control flow
// on its scalar unit: every ray pays for each cluster any ray of its block
// enters, and a block that holds one missing ray walks nearly all of them.
//
// What bounds it: the work the frame needs is a few slab tests and a few
// dozen triangle tests per ray, about 125 MB of boxes, sub-boxes and
// triangle rows for a 27M-triangle mesh under 512x512 rays: 0.0374 ms by
// bytes at 3.35 TB/s. In practice a ray's walk is a chain of dependent
// loads about five levels deep (a node's child boxes, then a child's), so
// latency bounds it, hidden by the many warps in flight.
//
// Design: one warp follows one ray down its own path and stops at its own
// depth; there is no block-wide vote and no barrier. The tree
// (bvh/clusters.py ClusterTree) is 32 wide because a warp is: a node keeps
// its children's boxes in one row of 32 floats per bound, so lane j loads
// child j with coalesced 4-byte loads, slab-tests it and a ballot gives the
// children entered. They go on a per-warp stack in shared memory as
// (level << 27 | index, entry t): the ordered walk pushes them far to near
// (each lane's rank by shuffles of the entry t's), so the nearest is popped
// next; the unordered walk pushes them in index order. A popped entry whose
// entry t is no longer within reach of the best hit is skipped. At a
// cluster the ordered walk's lanes slab-test its S / 8 sub-boxes, then test
// the 8 triangles of 4 entered sub-boxes per round, one triangle per lane;
// the unordered walk tests all S triangles, 32 per round. A warp reduction
// over (t, index) pairs updates the ray's best hit. The stack holds at most
// 31 entries per level above the clusters plus one: 187 for the 6 levels
// the 27-bit index allows.
//
// The function (equal to the plain version cluster_scalar_plain): each ray
// gets the nearest Möller-Trumbore hit t < max_dist over the triangles whose
// cluster box (ordered: and sub-box) its slab test enters at t < max_dist;
// a tie in t goes to the smallest sorted-triangle index (the update rule
// t < best or t == best and index < bidx, so a padding slot, which repeats
// its cluster's last real triangle at a larger index, never wins). A box is
// pruned only when its entry t lies beyond best by more than 2^-12 of best,
// a margin for the rounding of a triangle's t against its box's slab test;
// a box that holds a tie is kept.
//
// The tree never drops a cluster that a flat cull of the cluster boxes
// keeps: a parent box is the exact amin / amax of its children's, and
// fl((lo - o) * inv) is monotone in lo, so a parent's slab interval
// contains each child's in float too.
//
// A ray parallel to an axis whose origin lies on a box's plane there gives
// (lo - o) * (1 / d) = 0 * inf = NaN. The ray lies in the closed slab for
// every t, and the test takes it so, at every level. (The TPU kernels cull
// such a box for that ray, yet test its triangles when another ray of the
// block flags it, which finds the hits on the plane; a walk per ray has no
// such neighbours, and only the closed box gives the TPU kernels' depths on
// such rays.)
//
// Rounding: every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn, no FMA contraction), 3-term sums left
// to right, in the order of the JAX expressions, and 1/x is an IEEE
// division, so the kernel equals its plain PyTorch version bit for bit. The
// t of a failed test is never taken: the test's own comparisons are false
// for a NaN.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WIDTH = 32;       // children per node = lanes per warp
constexpr int SUB = 8;          // triangles per sub-box
constexpr int MAX_NSUB = 32;    // sub-boxes per cluster (one lane each)
constexpr int SHIFT = 27;       // stack entry: level << SHIFT | index
constexpr int MAX_LEVELS = 6;   // levels above the clusters, C < 2^27
constexpr int STACK = 192;      // >= 31 * MAX_LEVELS + 1 entries per warp
constexpr int WARPS = 4;        // rays per CUDA block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // origin, direction, 1 / d
};

// The tree and the cluster data, passed by value.
struct Tree {
  const float* nodes;      // (N, 6, WIDTH): internal nodes' child boxes
  const float* sub_boxes;  // (C, S / 8, 6), ordered walk only
  const float* tri;        // (C, S, 9)
  long long off[MAX_LEVELS + 1];  // first row of nodes of each level >= 1
  int size[MAX_LEVELS + 1];       // nodes per level, the clusters first
  int top;                        // the root's level
  int S;
};

// One axis of the slab test: the entry and exit t of the slab [l, h]. A NaN
// is 0 * inf: the ray runs in one of the slab's planes, inside the closed
// slab for every t.
__device__ __forceinline__ void axis(float l, float h, float o, float inv,
                                     float& lo, float& hi) {
  const float a = mul(sub(l, o), inv), b = mul(sub(h, o), inv);
  const bool on = a != a || b != b;
  lo = on ? -CUDART_INF_F : fminf(a, b);
  hi = on ? CUDART_INF_F : fmaxf(a, b);
}

// Does the ray enter box [lo xyz, hi xyz] ahead of its origin, nearer than
// max_dist and within reach of the best hit (reach)? tmin: its entry t.
__device__ __forceinline__ bool enters(float lx, float ly, float lz, float hx,
                                       float hy, float hz, const Ray& r,
                                       float max_dist, float reach,
                                       float& tmin) {
  float x0, x1, y0, y1, z0, z1;
  axis(lx, hx, r.ox, r.ix, x0, x1);
  axis(ly, hy, r.oy, r.iy, y0, y1);
  axis(lz, hz, r.oz, r.iz, z0, z1);
  tmin = fmaxf(fmaxf(x0, y0), z0);
  const float tmax = fminf(fminf(x1, y1), z1);
  return tmin <= tmax && tmax >= 0.0f && tmin < max_dist && tmin <= reach;
}

// Möller-Trumbore against one triangle row [a, e1 = b - a, e2 = c - a]:
// (t, id) of a hit, (inf, INT_MAX) of a miss.
__device__ __forceinline__ void triangle(const float* __restrict__ p,
                                         const Ray& r, int id, float& tb,
                                         int& ib) {
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
      add(u, v) <= 1.0f && t >= 0.0f) {
    tb = t;
    ib = id;
  }
}

// The warp's smallest (t, id), t first, in every lane. Ids are unique, so
// every lane takes the same pair.
__device__ __forceinline__ void warp_min(float& t, int& id) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float t2 = __shfl_xor_sync(FULL, t, s);
    const int i2 = __shfl_xor_sync(FULL, id, s);
    if (t2 < t || (t2 == t && i2 < id)) {
      t = t2;
      id = i2;
    }
  }
}

// A round's winner against the ray's best hit: a tie goes to the smaller id.
__device__ __forceinline__ void take(float t, int id, float& best,
                                     int& bidx) {
  if (t < best || (t == best && id < bidx)) {
    best = t;
    bidx = id;
  }
}

template <bool ORDERED>
__global__ void __launch_bounds__(WARPS * 32) cluster_scalar_kernel(
    Tree tr, const float* __restrict__ rays, long long R, float max_dist,
    float* __restrict__ depth, int* __restrict__ idx,
    int* __restrict__ counts) {
  __shared__ int s_ent[WARPS][STACK];
  __shared__ float s_key[WARPS][STACK];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * WARPS + w;
  if (ray >= R) return;  // the whole warp
  int* ent = s_ent[w];
  float* key = s_key[w];
  // rays: (6, R) rows ox, oy, oz, dx, dy, dz; every lane holds the ray
  Ray r;
  r.ox = __ldg(rays + ray);
  r.oy = __ldg(rays + R + ray);
  r.oz = __ldg(rays + 2 * R + ray);
  r.dx = __ldg(rays + 3 * R + ray);
  r.dy = __ldg(rays + 4 * R + ray);
  r.dz = __ldg(rays + 5 * R + ray);
  r.ix = __fdiv_rn(1.0f, r.dx);
  r.iy = __fdiv_rn(1.0f, r.dy);
  r.iz = __fdiv_rn(1.0f, r.dz);
  const int S = tr.S;
  float best = max_dist;
  int bidx = -1;
  int nodes = 0, boxes = 0, subs = 0, tris = 0;

  if (lane == 0) {
    ent[0] = tr.top << SHIFT;
    key[0] = -CUDART_INF_F;
  }
  int sp = 1;
  __syncwarp();
  while (sp > 0) {
    --sp;
    const int e = ent[sp];
    const float k = key[sp];
    __syncwarp();  // every lane has read slot sp before it is written again
    const float reach = add(best, mul(best, 0x1p-12f));
    if (!(k <= reach)) continue;
    const int level = e >> SHIFT;
    const int i = e & ((1 << SHIFT) - 1);
    if (level > 0) {
      // a node: lane j tests child j
      ++nodes;
      const int first = i * WIDTH;
      boxes += min(WIDTH, tr.size[level - 1] - first);
      const float* nb =
          tr.nodes + (tr.off[level] + i) * (6 * WIDTH) + lane;
      float tmin;
      const bool in = enters(__ldg(nb), __ldg(nb + WIDTH),
                             __ldg(nb + 2 * WIDTH), __ldg(nb + 3 * WIDTH),
                             __ldg(nb + 4 * WIDTH), __ldg(nb + 5 * WIDTH), r,
                             max_dist, reach, tmin);
      const unsigned mask = __ballot_sync(FULL, in);
      int pos;  // entries of this push that lie below the lane's
      if (ORDERED) {
        // far to near; at equal entry t the smaller index is popped first
        pos = 0;
        for (unsigned m = mask; m != 0; m &= m - 1) {
          const int b = __ffs(m) - 1;
          const float tb = __shfl_sync(FULL, tmin, b);
          pos += (tb > tmin || (tb == tmin && b > lane)) ? 1 : 0;
        }
      } else {
        pos = __popc(mask & ~((2u << lane) - 1u));  // index order
      }
      if (in) {
        ent[sp + pos] = ((level - 1) << SHIFT) | (first + lane);
        key[sp + pos] = tmin;
      }
      sp += __popc(mask);
      __syncwarp();
      continue;
    }
    // a cluster
    const float* tc = tr.tri + (long long)i * S * 9;
    if (ORDERED) {
      const int nsub = S / SUB;
      subs += nsub;
      bool in = false;
      if (lane < nsub) {
        const float* sb = tr.sub_boxes + ((long long)i * nsub + lane) * 6;
        float tmin;
        in = enters(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2), __ldg(sb + 3),
                    __ldg(sb + 4), __ldg(sb + 5), r, max_dist, reach, tmin);
      }
      unsigned smask = __ballot_sync(FULL, in);
      tris += SUB * __popc(smask);
      while (smask != 0) {
        // 4 sub-boxes a round: lane l tests triangle l & 7 of the
        // (l >> 3)-th of them
        int s = -1;
        for (int q = 0; q < 4 && smask != 0; ++q) {
          const int b = __ffs(smask) - 1;
          smask &= smask - 1;
          if ((lane >> 3) == q) s = b;
        }
        float t = CUDART_INF_F;
        int id = INT_MAX;
        if (s >= 0) {
          const int m = s * SUB + (lane & 7);
          triangle(tc + m * 9, r, i * S + m, t, id);
        }
        warp_min(t, id);
        take(t, id, best, bidx);
      }
    } else {
      tris += S;
      for (int base = 0; base < S; base += WIDTH) {
        float t = CUDART_INF_F;
        int id = INT_MAX;
        const int m = base + lane;
        if (m < S) triangle(tc + m * 9, r, i * S + m, t, id);
        warp_min(t, id);
        take(t, id, best, bidx);
      }
    }
  }

  if (lane == 0) {
    depth[ray] = best;
    idx[ray] = bidx;
    if (counts != nullptr) {
      int* c = counts + 4 * ray;
      c[0] = nodes;
      c[1] = boxes;
      c[2] = subs;
      c[3] = tris;
    }
  }
}

template <bool ORDERED>
int launch(const float* nodes, const float* sub_boxes, const float* tri,
           const float* rays, long long R, int C, int S, float max_dist,
           float* depth, int* idx, int* counts, cudaStream_t stream) {
  if (R < 1 || C < 1 || S < 1 || C >= (1 << SHIFT) ||
      (long long)C * S > 0x7FFFFFFFLL ||
      (ORDERED && (S % SUB != 0 || S / SUB > MAX_NSUB))) {
    return (int)cudaErrorInvalidValue;
  }
  Tree tr;
  tr.nodes = nodes;
  tr.sub_boxes = sub_boxes;
  tr.tri = tri;
  tr.S = S;
  tr.size[0] = C;
  tr.off[0] = 0;  // the clusters have no rows in nodes
  long long rows = 0;
  int k = 0;
  do {  // one level above the clusters at least, up to a single root
    tr.size[k + 1] = (tr.size[k] + WIDTH - 1) / WIDTH;
    tr.off[k + 1] = rows;
    rows += tr.size[k + 1];
    ++k;
  } while (tr.size[k] > 1);
  tr.top = k;
  for (int q = k + 1; q <= MAX_LEVELS; ++q) {
    tr.size[q] = 0;
    tr.off[q] = 0;
  }
  const unsigned grid = (unsigned)((R + WARPS - 1) / WARPS);
  cluster_scalar_kernel<ORDERED><<<grid, WARPS * 32, 0, stream>>>(
      tr, rays, R, max_dist, depth, idx, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Walk with the sub-box cull: nodes (N, 6, 32) float32, the ClusterTree's
// child boxes (level 1 first, the root last); sub_boxes (C, S / 8, 6), tri
// (C, S, 9), rays (6, R) rows [o; d]; depth (R,) float32, idx (R,) int32
// sorted-triangle index (-1: no hit); counts (R, 4) int32 [nodes entered,
// child boxes tested, sub-boxes tested, triangles tested] or null.
extern "C" int cluster_scalar_ordered(const float* nodes,
                                      const float* sub_boxes,
                                      const float* tri, const float* rays,
                                      long long R, int C, int S,
                                      float max_dist, float* depth, int* idx,
                                      int* counts, cudaStream_t stream) {
  return launch<true>(nodes, sub_boxes, tri, rays, R, C, S, max_dist, depth,
                      idx, counts, stream);
}

// Walk with the cluster cull only: the same arrays without sub-boxes.
extern "C" int cluster_scalar(const float* nodes, const float* tri,
                              const float* rays, long long R, int C, int S,
                              float max_dist, float* depth, int* idx,
                              int* counts, cudaStream_t stream) {
  return launch<false>(nodes, nullptr, tri, rays, R, C, S, max_dist, depth,
                       idx, counts, stream);
}
