// Marching-cubes mask pass for Hopper (sm_90a).
//
// Replaces: primitive3d_tpu/kernels/mc_masks.py:29 `_kernel` (wrapper
// `fused_masks`), the Pallas TPU kernel that sweeps x-slabs of the density
// grid with a one-row +x halo and writes the three edge-crossing masks and
// the 8-bit corner mask of every cube in one pass.
//
// Outputs, each in its valid shape (the TPU pads only for its tiling):
//   cx (X-1, Y, Z) int8, cy (X, Y-1, Z) int8, cz (X, Y, Z-1) int8,
//   cube mask (X-1, Y-1, Z-1) uint8 with bit k = corner k inside, corners
//   0..7 = (0,0,0) (1,0,0) (1,1,0) (0,1,0) (0,0,1) (1,0,1) (1,1,1) (0,1,1);
//   inside is `density > thresh`, so NaN is outside.
//
// What bounds it on this card: bytes. Each grid value is read once (4 B)
// and each output byte written once (about 4 B per cell): at 256^3 ~67 MB
// in and ~67 MB out, ~40 us at 3.35 TB/s.
//
// Design. A block owns a tile of TY whole z-rows (rows y0 .. y0+TY-1 of
// every slice) and walks a slab of XS slices along x:
//   * Each density value is read from device memory once, plus a one-row
//     (+y) and a one-slice (+x) halo: rows y0 .. y0+TY of slice x are one
//     contiguous range of the grid, read with coalesced loads. The next
//     slice's loads are issued into registers before the current slice's
//     masks are computed, so they are in flight during that work (a
//     software pipeline; with several blocks per SM that keeps enough bytes
//     in flight, and needs no cp.async or mbarrier).
//   * The loaded values become occupancy bytes (0/1) in shared memory, and
//     each cell's byte then becomes its yz-face code
//         q = o(y,z) | o(y+1,z) << 1 | o(y,z+1) << 2 | o(y+1,z+1) << 3,
//     four cells per 32-bit word (SIMD within a register). Every mask byte
//     of cell (x, y, z) is a function of q_x and q_{x+1} at (y, z) alone:
//     cx = (q_x ^ q_x+1) & 1, cy = (q ^ q >> 1) & 1, cz = (q ^ q >> 2) & 1,
//     and the corner mask spreads q_x's bits to corners 0, 3, 4, 7 and
//     q_x+1's to 1, 2, 5, 6. Two slices of q are kept, so each is computed
//     once and used as "this slice" and as "the next".
//   * Each mask of one slice of a tile is one contiguous byte range of the
//     output, also for rows of Z-1 bytes. The block writes the range's
//     4-byte-aligned middle one aligned word per thread, so a warp stores
//     128 contiguous bytes per instruction, and its ragged head and tail
//     bytes one by one. A word's bytes come from the q row at local byte
//     l + r (r = the row of l; only cz and the corner mask, whose rows drop
//     the last z, shift), read as two aligned shared-memory words and a
//     funnel shift; a row boundary inside the word takes the bytes past it
//     from the window one byte further on. Lanes read consecutive words, so
//     the reads are free of bank conflicts; 16-byte stores per thread would
//     put lanes 16 bytes apart and make them 4-way, for the same 128-byte
//     lines in device memory. The row of a word is a float estimate and a
//     correction (no integer division), and the index math is 32-bit
//     within a tile.
// The host picks TY (at most 4096 loaded cells per slice, 16 per thread)
// and XS so that the grid is about one wave of the blocks the card holds at
// once (a second, part-filled wave would leave most SMs idle at its end).
// A grid small enough for one wave of one-slice blocks (66^3) gets those,
// each loading its two slices in one round trip: its time is memory
// latency, and a deeper pipeline per block would only add round trips.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;                    // prefetched values
constexpr int TILE_CELLS = THREADS * PER_THREAD;  // cells loaded per slice
constexpr unsigned ONES = 0x01010101u;
constexpr int MAX_Z = 32768;  // kernels/mc_masks.py MAX_Z

// the 4 bytes at byte offset p of a shared-memory byte array (p >= 0)
__device__ __forceinline__ unsigned window(const unsigned* a, unsigned p) {
  return __funnelshift_r(a[p >> 2], a[(p >> 2) + 1], (p & 3u) * 8u);
}

enum Mask { CX = 0, CY = 1, CZ = 2, CM = 3 };

// the mask bytes of 4 cells from their q codes (SIMD within a word)
template <int M>
__device__ __forceinline__ unsigned mask_of(unsigned qc, unsigned qn) {
  if (M == CX) return (qc ^ qn) & ONES;
  if (M == CY) return (qc ^ (qc >> 1)) & ONES;
  if (M == CZ) return (qc ^ (qc >> 2)) & ONES;
  return (qc & ONES) | ((qc & 0x06060606u) << 2) | ((qc & 0x08080808u) << 4) |
         ((qn & 0x03030303u) << 1) | ((qn & 0x0c0c0c0cu) << 3);
}

// row of local byte l in rows of w bytes: a float estimate, then corrected
// (l < 2^24, so the estimate is off by at most one)
__device__ __forceinline__ unsigned row_of(unsigned l, unsigned w,
                                           float inv_w) {
  unsigned r = __float2uint_rz(__uint2float_rz(l) * inv_w);
  if (r * w > l) --r;
  if ((r + 1) * w <= l) ++r;
  return r;
}

// One mask of one slice of the tile: bytes [0, len) of the output at
// `out`, local byte l of which is the cell at q offset l (+ its row for cz
// and the corner mask, whose rows are w = Z - 1 bytes long).
template <int M>
__device__ void write_mask(unsigned char* __restrict__ out, unsigned len,
                           unsigned w, float inv_w, const unsigned* qc,
                           const unsigned* qn) {
  constexpr bool SHIFT = M == CZ || M == CM;
  constexpr bool NEXT = M == CX || M == CM;  // reads slice x + 1
  const unsigned char* qcb = reinterpret_cast<const unsigned char*>(qc);
  const unsigned char* qnb = reinterpret_cast<const unsigned char*>(qn);
  const unsigned head = min(len, (unsigned)((4u - ((uintptr_t)out & 3u)) & 3u));
  const unsigned body = (len - head) & ~3u;
  // ragged head and tail, one byte each
  for (unsigned k = threadIdx.x; k < len - body; k += THREADS) {
    const unsigned l = k < head ? k : k + body;
    const unsigned f = SHIFT ? l + row_of(l, w, inv_w) : l;
    out[l] = (unsigned char)mask_of<M>(qcb[f], NEXT ? qnb[f] : 0u);
  }
  // the aligned middle, one 4-byte word per thread: a warp stores 128
  // contiguous bytes and reads consecutive shared-memory words
  for (unsigned l = head + threadIdx.x * 4u; l < head + body;
       l += THREADS * 4u) {
    unsigned v;
    if (!SHIFT) {
      v = mask_of<M>(window(qc, l), NEXT ? window(qn, l) : 0u);
    } else if (w >= 4) {  // at most one row boundary in a word
      const unsigned r = row_of(l, w, inv_w);
      const unsigned left = (r + 1) * w - l;  // bytes before the boundary
      const unsigned f = l + r;
      unsigned a = window(qc, f), an = NEXT ? window(qn, f) : 0u;
      if (left < 4) {  // bytes from `left` on lie in row r + 1
        const unsigned keep = (1u << (8 * left)) - 1u;
        a = (a & keep) | (window(qc, f + 1) & ~keep);
        if (NEXT) an = (an & keep) | (window(qn, f + 1) & ~keep);
      }
      v = mask_of<M>(a, an);
    } else {  // rows of 1-3 bytes: byte by byte
      v = 0;
      for (int j = 0; j < 4; ++j) {
        const unsigned f = l + j + row_of(l + j, w, inv_w);
        v |= mask_of<M>(qcb[f], NEXT ? qnb[f] : 0u) << (8 * j);
      }
    }
    *reinterpret_cast<unsigned*>(out + l) = v;
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS) mc_masks_kernel(
    const float* __restrict__ dens, float thresh, int X, int Y, int Z, int TY,
    int XS, unsigned nbuf, int8_t* __restrict__ cx, int8_t* __restrict__ cy,
    int8_t* __restrict__ cz, uint8_t* __restrict__ cm) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* occ = smem;                                  // one slice
  unsigned* qa = reinterpret_cast<unsigned*>(smem + nbuf);    // q of x
  unsigned* qb = reinterpret_cast<unsigned*>(smem + 2 * nbuf);  // of x + 1

  const int y0 = blockIdx.x * TY;
  const int xa = blockIdx.y * XS;
  const int xb = min(X, xa + XS);  // this block writes slices xa .. xb-1
  const int rows = min(TY, Y - y0);        // rows of cx and cz
  const int rows_h = min(TY + 1, Y - y0);  // rows loaded (+y halo)
  const unsigned n = (unsigned)rows_h * Z;  // cells loaded per slice
  const unsigned nq = (unsigned)rows * Z;   // q codes per slice
  const int tid = threadIdx.x;
  const unsigned w = Z - 1;  // bytes per row of cz and the corner mask
  const float inv_w = 1.0f / (float)w;

  // The prefetch loads cells [0, cnt) of slice xs's tile into registers;
  // cells from n on are slice xs + 1's (a pair: both slices of a
  // one-slice block at once). VEC4 (Z % 4 == 0, so every slice's rows
  // start 16-byte aligned): a thread loads 4 consecutive values at once
  // and stores their 4 occupancy bytes as one word.
  float v[PER_THREAD];
  auto prefetch = [&](int xs, unsigned cnt) {
    const float* src = dens + ((long long)xs * Y + y0) * Z;
    const long long next = (long long)Y * Z - n;  // cell n -> slice xs + 1
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k) {
      if (VEC4) {
        const unsigned i = 4 * (tid + k * THREADS);
        const float4 f =
            i < cnt ? __ldg(reinterpret_cast<const float4*>(
                          src + i + (i < n ? 0 : next)))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * k] = f.x;
        v[4 * k + 1] = f.y;
        v[4 * k + 2] = f.z;
        v[4 * k + 3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned i = tid + (4 * k + j) * THREADS;
          v[4 * k + j] = i < cnt ? __ldg(src + i + (i < n ? 0 : next)) : 0.f;
        }
      }
    }
  };
  // occupancy bytes of slice xs from the prefetched cells [lo, lo + n)
  // (and, past TILE_CELLS cells, loads made here), then its q codes
  auto fill = [&](int xs, unsigned lo, unsigned* q) {
#pragma unroll
    for (int k = 0; k < PER_THREAD / 4; ++k) {
      if (VEC4) {
        const unsigned i = 4 * (tid + k * THREADS) - lo;
        if (i < n) {  // unsigned: also false below lo
          reinterpret_cast<unsigned*>(occ)[i / 4] =
              (unsigned)(v[4 * k] > thresh) |
              (unsigned)(v[4 * k + 1] > thresh) << 8 |
              (unsigned)(v[4 * k + 2] > thresh) << 16 |
              (unsigned)(v[4 * k + 3] > thresh) << 24;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned i = tid + (4 * k + j) * THREADS - lo;
          if (i < n) occ[i] = v[4 * k + j] > thresh;
        }
      }
    }
    const float* src = dens + ((long long)xs * Y + y0) * Z;
    for (unsigned i = TILE_CELLS + tid; i < n; i += THREADS) {
      occ[i] = __ldg(src + i) > thresh;
    }
    __syncthreads();
    const unsigned* o = reinterpret_cast<const unsigned*>(occ);
    for (unsigned j = tid; 4 * j < nq; j += THREADS) {
      const unsigned f = 4 * j;
      q[j] = (o[j] & ONES) | ((window(o, f + Z) & ONES) << 1) |
             ((window(o, f + 1) & ONES) << 2) |
             ((window(o, f + Z + 1) & ONES) << 3);
    }
    __syncthreads();
  };

  // a one-slice block whose two slices fit the registers loads both at
  // once: one round trip to memory instead of two
  const bool pair = xb - xa == 1 && xa + 1 < X && 2 * n <= TILE_CELLS;
  prefetch(xa, pair ? 2 * n : n);
  fill(xa, 0, qa);
  if (xa + 1 < X) {
    if (!pair) prefetch(xa + 1, n);
    fill(xa + 1, pair ? n : 0, qb);
  }
  for (int x = xa; x < xb; ++x) {
    const bool next2 = x + 2 < X && x + 1 < xb;  // slice x + 2 is needed
    if (next2) prefetch(x + 2, n);
    if (x + 1 < X) {
      write_mask<CX>(reinterpret_cast<unsigned char*>(cx) +
                         ((long long)x * Y + y0) * Z,
                     nq, Z, 0.0f, qa, qb);
      write_mask<CM>(cm + ((long long)x * (Y - 1) + y0) * w,
                     (unsigned)(rows_h - 1) * w, w, inv_w, qa, qb);
    }
    write_mask<CY>(reinterpret_cast<unsigned char*>(cy) +
                       ((long long)x * (Y - 1) + y0) * Z,
                   (unsigned)(rows_h - 1) * Z, Z, 0.0f, qa, qb);
    write_mask<CZ>(reinterpret_cast<unsigned char*>(cz) +
                       ((long long)x * Y + y0) * w,
                   (unsigned)rows * w, w, inv_w, qa, qb);
    if (next2) {
      __syncthreads();  // every thread is done reading qa
      fill(x + 2, 0, qa);
    }
    unsigned* t = qa;
    qa = qb;
    qb = t;
  }
}

// dynamic shared memory each instance may take, raised once per size
int g_smem_set[2] = {48 * 1024, 48 * 1024};

}  // namespace

extern "C" int mc_masks(const float* dens, float thresh, int X, int Y, int Z,
                        int8_t* cx, int8_t* cy, int8_t* cz, uint8_t* cm,
                        cudaStream_t stream) {
  // MAX_Z: three buffers of two rows must fit a block's shared memory
  if (X < 2 || Y < 2 || Z < 2 || Z > MAX_Z || (long long)Y * Z > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  // TY rows and a halo row of at most TILE_CELLS cells; fewer rows while
  // the (tile, slice) pairs are fewer than the blocks the card holds at
  // once; then XS slices per block so that the grid is one wave of them
  const bool vec4 = Z % 4 == 0 && ((uintptr_t)dens & 15) == 0;
  const void* fn = vec4 ? (const void*)mc_masks_kernel<true>
                        : (const void*)mc_masks_kernel<false>;
  int TY = TILE_CELLS / Z - 1;
  TY = TY < 1 ? 1 : (TY > Y ? Y : TY);
  auto smem_bytes = [&](int ty) {
    return 3 * (int)((((long long)(ty + 1) * Z + 16) + 15) / 16 * 16);
  };
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, THREADS, smem_bytes(TY));
  }
  if (err != cudaSuccess) return (int)err;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // a small grid: the fewest rows a tile (the most blocks) such that one
  // slice a block is one wave and a block's two slices fit its registers
  int small = 0;
  for (int ty = 1; ty <= Y && 2LL * (ty + 1) * Z <= TILE_CELLS; ++ty) {
    if ((long long)((Y + ty - 1) / ty) * X <= wave) {
      small = ty;
      break;
    }
  }
  int XS = 1;
  if (small) {
    TY = small;
  } else {
    while ((long long)((Y + TY - 1) / TY) * X < wave && TY > 1) {
      TY = (TY + 1) / 2;
    }
    const long long tiles = (Y + TY - 1) / TY;
    const long long slabs = wave / tiles > 1 ? wave / tiles : 1;
    XS = (int)((X + slabs - 1) / slabs);
    while ((X + XS - 1) / XS > 65535) XS *= 2;
  }
  const unsigned nbuf = (unsigned)(smem_bytes(TY) / 3);
  const int bytes = smem_bytes(TY);
  if (bytes > g_smem_set[vec4]) {  // once per size above the default 48 KB
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[vec4] = bytes;
  }
  const dim3 grid((Y + TY - 1) / TY, (X + XS - 1) / XS);
  if (vec4) {
    mc_masks_kernel<true><<<grid, THREADS, bytes, stream>>>(
        dens, thresh, X, Y, Z, TY, XS, nbuf, cx, cy, cz, cm);
  } else {
    mc_masks_kernel<false><<<grid, THREADS, bytes, stream>>>(
        dens, thresh, X, Y, Z, TY, XS, nbuf, cx, cy, cz, cm);
  }
  return (int)cudaGetLastError();
}
