// Duration-banded Hamming adjacency over packed hashes: the two kernels of
// the two-phase sweep.
//
//   band_counts_kernel  (phase A) replaces the Pallas kernel
//       vid_dup_finder_lib_tpu/ops/hamming_pallas.py _build_chunk_counts:
//       one match count per (row tile, column tile) of the band.
//   band_pack_kernel    (phase B) replaces the Pallas kernel
//       vid_dup_finder_lib_tpu/ops/hamming_pallas.py _build_chunk:
//       the transposed bitpacked adjacency of the tiles phase A found hits in.
//
// Rows and columns come from two packed matrices: the self-search passes
// the library as both, the references search passes the references as
// rows and the candidate library as columns.  The predicate both kernels
// evaluate for row r and column c:
//     ham(r, c) <= tol  &&  lo(r) < c  &&  c < min(bounds[r], n)
// where lo(r) = row_lo[r] when a row_lo array is given (the references
// search's per-row [0.95d, 1.05d] window, row_lo = lo - 1) and lo(r) = r
// when it is null (the self-search's c > r), as the TPU kernels' row_lo
// operand does (hamming_pallas.py:234-243).  ham counts all 1024 storage
// bits (pad bits included, like the reference's 16-word popcount).  Pad
// rows carry bounds = -1 (and row_lo = 2^30) and never match; columns at
// or past n never match, whatever a resident matrix holds there.
//
// band_counts_kernel on an H100.  Its work is one 1024-deep dot product
// per in-band pair: at chip_smoke.py's 1M library the band holds 4.587e10
// pairs, 2 * 1024 * 4.587e10 int8 operations, 47.5 ms at the tensor
// cores' 1,979 TOP/s int8 rate; its bytes (the packed library, 128 MB)
// take 0.04 ms.  So the tensor cores bound it.  Each packed bit expands in
// shared memory to an int8 +/-1 (bit 1 -> +1, bit 0 -> -1), and
//     dot(r, c) = 1024 - 2 * ham(r, c)
// exactly in int32, so ham <= tol is dot >= 1024 - 2 * tol.  Any bit order
// serves as long as rows and columns expand alike.
//
// Design.  A block (two warpgroups, 256 threads) owns a run of up to SEG
// column tiles of one row tile's band.  It expands its 128-row tile once,
// into 128 KB of shared memory: eight K slabs of 128 rows x 128 bytes in
// the 128-byte swizzled layout that wgmma's descriptors read.  Column
// tiles are read packed (16 KB per tile, one tile ahead into registers)
// and expanded one K slab at a time into a ring of two 16 KB slabs: while
// warpgroup w's wgmma.m64n128k32 (s8 x s8 -> s32) runs on slab k over its
// 64 rows, the block expands slab k + 1.  After the eighth slab each
// thread compares its 64 accumulators with the threshold and its two
// rows' windows (lo, min(bounds, n)) and the warps add their counts into
// the (row tile, slot) entry with one atomic each, skipping zero counts;
// the wrapper zeroes the output.  Library reads stay packed: no int8
// copy of the library goes to device memory.
//
// The TPU grid ran in order and carried a row tile's count across the
// band axis in its output block.  CUDA blocks run in any order, so each
// block writes its own entries and nothing is carried between blocks.
// The grid covers the whole [row tiles, runs of SEG slots] rectangle;
// a block past its row tile's band exits at once.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using vdf::TILE;
using vdf::VEC;
using vdf::WORDS;
using vdf::hamming;

// -- band_counts_kernel: int8 +/-1 on the tensor cores --------------------

constexpr int SEG = 32;                   // column tiles per block
constexpr int THREADS = 256;              // two warpgroups, 64 rows each
constexpr int SLAB = 128;                 // bytes of K per row of a slab (one swizzle atom row)
constexpr int SLABS = 1024 / SLAB;        // K = 1024 int8 values
constexpr int SLAB_BYTES = TILE * SLAB;   // 16 KB
constexpr int SMEM = SLABS * SLAB_BYTES   // the expanded row tile
                     + 2 * SLAB_BYTES     // the ring of column slabs
                     + TILE * 8           // win[]
                     + 1024;              // slack for the 1024-byte alignment

// Four bits -> four int8 +/-1: the multiply spreads bit i to bit 8i (no
// carries), the second sets a byte to 0xFE per set bit, the xor maps
// 0 -> 0xFF (-1) and 0xFE -> 0x01 (+1).
__device__ __forceinline__ uint32_t pm1x4(uint32_t nib) {
  return 0xFFFFFFFFu ^ (((nib * 0x00204081u) & 0x01010101u) * 0xFEu);
}

__device__ __forceinline__ uint4 pm1x16(uint32_t v) {
  return make_uint4(pm1x4(v & 15u), pm1x4((v >> 4) & 15u), pm1x4((v >> 8) & 15u),
                    pm1x4((v >> 12) & 15u));
}

// Thread (r, h) expands words 2h, 2h + 1 of one slab of row r (64 bits)
// into the four 16-byte chunks 4h .. 4h + 3 of the slab's row r, chunk j
// stored at chunk position j ^ (r % 8): the 128-byte swizzle.  The eight
// threads of a quarter warp hit eight distinct chunk positions.
__device__ __forceinline__ void expand(uint8_t* slab, int r, int h, uint2 w) {
  uint8_t* row = slab + r * SLAB;
  const int sw = r & 7;
  *reinterpret_cast<uint4*>(row + (((4 * h + 0) ^ sw) << 4)) = pm1x16(w.x & 0xFFFFu);
  *reinterpret_cast<uint4*>(row + (((4 * h + 1) ^ sw) << 4)) = pm1x16(w.x >> 16);
  *reinterpret_cast<uint4*>(row + (((4 * h + 2) ^ sw) << 4)) = pm1x16(w.y & 0xFFFFu);
  *reinterpret_cast<uint4*>(row + (((4 * h + 3) ^ sw) << 4)) = pm1x16(w.y >> 16);
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset (unused by swizzled K-major
// layouts, 16 B), stride 1024 B between 8-row groups, layout type 1.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

#define VDF_D8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                  "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64] (+)= A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : VDF_D8(0), VDF_D8(8), VDF_D8(16), VDF_D8(24), VDF_D8(32), VDF_D8(40),
        VDF_D8(48), VDF_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef VDF_D8

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy shared stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
band_counts_kernel(const int32_t* __restrict__ rows_m,    // [row tiles * TILE, 32]
                   const int32_t* __restrict__ cols_m,    // [col tiles * TILE, 32]
                   const int32_t* __restrict__ bounds,    // [rows], -1 on pad rows
                   const int32_t* __restrict__ row_lo,    // [rows] or null (c > r)
                   const int32_t* __restrict__ first_ct,  // [row tiles]
                   const int32_t* __restrict__ n_ct,      // [row tiles]
                   int32_t* __restrict__ counts,          // [row tiles, slots], zeroed
                   int slots, int n, int thresh) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* a_s = smem_raw + (((base + 1023u) & ~1023u) - base);  // [SLABS][TILE][SLAB]
  uint8_t* b_s = a_s + SLABS * SLAB_BYTES;                       // [2][TILE][SLAB]
  int2* win = reinterpret_cast<int2*>(b_s + 2 * SLAB_BYTES);     // per row: (lo, hi)

  const int segs = (slots + SEG - 1) / SEG;
  const int rt = static_cast<int>(blockIdx.x / segs);
  const int t0 = static_cast<int>(blockIdx.x % segs) * SEG;
  const int t1 = min(t0 + SEG, n_ct[rt]);
  if (t0 >= t1) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int er = tid >> 1;  // expansion: this thread's row / column of a tile
  const int eh = tid & 1;   // ... and its half of each 16-byte slab row
  const int64_t r0 = static_cast<int64_t>(rt) * TILE;
  if (tid < TILE) {
    win[tid] = make_int2(row_lo ? row_lo[r0 + tid] : static_cast<int>(r0) + tid,
                         min(bounds[r0 + tid], n));
  }

  // The row tile, expanded once.  Slab k holds words 4k .. 4k + 3 of a
  // row, which are uint2 2k and 2k + 1.
  const uint2* rsrc = reinterpret_cast<const uint2*>(rows_m + (r0 + er) * WORDS) + eh;
#pragma unroll
  for (int k = 0; k < SLABS; ++k) expand(a_s + k * SLAB_BYTES, er, eh, rsrc[2 * k]);

  const int ct0 = first_ct[rt];
  const uint2* cbase = reinterpret_cast<const uint2*>(cols_m) +
                       (static_cast<int64_t>(ct0) * TILE + er) * (WORDS / 2) + eh;
  constexpr int64_t TILE_U2 = static_cast<int64_t>(TILE) * (WORDS / 2);
  uint2 cur[SLABS], nxt[SLABS];
#pragma unroll
  for (int k = 0; k < SLABS; ++k) cur[k] = cbase[t0 * TILE_U2 + 2 * k];
  expand(b_s, er, eh, cur[0]);
  fence_async_smem();
  __syncthreads();

  // This thread's accumulator rows (wgmma's D fragment): warp w of the
  // warpgroup holds rows 16w .. 16w + 15; d[4j + e] is row qr (+8 when
  // e >= 2), column 8j + 2 (lane % 4) (+1 when e is odd).
  const int qr = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int2 w0 = win[qr];
  const int2 w1 = win[qr + 8];
  const int cq = 2 * (lane & 3);
  const uint64_t da = smem_desc(a_s + wg * 64 * SLAB);
  const uint64_t db = smem_desc(b_s);

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) {
#pragma unroll
      for (int k = 0; k < SLABS; ++k) nxt[k] = cbase[(t + 1) * TILE_U2 + 2 * k];
    }
#pragma unroll
    for (int k = 0; k < SLABS; ++k) {
      // slab k of the column tile sits in ring slot k % 2 (SLABS is even)
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SLAB / 32; ++kk) {
        wgmma_s8(d, da + ((k * SLAB_BYTES + kk * 32) >> 4),
                 db + (((k & 1) * SLAB_BYTES + kk * 32) >> 4), (k | kk) != 0);
      }
      wgmma_commit();
      fence_operands(d);
      wgmma_wait<1>();  // this warpgroup's products of slab k - 1 are done
      __syncthreads();  // ... and the other's: ring slot (k + 1) % 2 is free
      uint8_t* next = b_s + ((k + 1) & 1) * SLAB_BYTES;
      if (k + 1 < SLABS) {
        expand(next, er, eh, cur[k + 1]);
      } else if (t + 1 < t1) {
        expand(next, er, eh, nxt[0]);
      }
      fence_async_smem();
      __syncthreads();
    }
    wgmma_wait<0>();
    fence_operands(d);

    const int c0 = (ct0 + t) * TILE;
    int cnt = 0;
    if (c0 > max(w0.x, w1.x) && c0 + TILE <= min(w0.y, w1.y)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) cnt += d[i] >= thresh;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = c0 + 8 * (i >> 2) + cq + (i & 1);
        const int2 w = (i & 2) ? w1 : w0;
        cnt += (d[i] >= thresh) & (c > w.x) & (c < w.y);
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0 && cnt) atomicAdd(counts + static_cast<int64_t>(rt) * slots + t, cnt);
#pragma unroll
    for (int k = 0; k < SLABS; ++k) cur[k] = nxt[k];
  }
}

// -- band_pack_kernel ------------------------------------------------------

// One block per hit tile.  Thread t owns row rt*TILE + t (its 32 words in
// registers); warp w's 32 lanes are rows w*32 .. w*32+31, so a ballot over
// the predicate of one column is word [w, c] of the transposed layout:
// bit b = row w*32 + b.  Lane (c % 32) keeps the word of column c and the
// warp stores 32 columns at a time, coalesced.
__global__ void __launch_bounds__(TILE)
band_pack_kernel(const int32_t* __restrict__ rows_m,  // [row tiles * TILE, 32]
                 const int32_t* __restrict__ cols_m,  // [col tiles * TILE, 32]
                 const int32_t* __restrict__ bounds,  // [rows]
                 const int32_t* __restrict__ row_lo,  // [rows] or null (c > r)
                 const int32_t* __restrict__ hits,    // [H, 2]: row tile, col tile
                 int32_t* __restrict__ words,         // [H, TILE / 32, TILE]
                 int n, int tol) {
  const int64_t h = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = hits[2 * h] * TILE + tid;
  const int c0 = hits[2 * h + 1] * TILE;

  __shared__ uint4 cols[TILE][VEC];  // 16 KB: the column tile
  const uint4* csrc = reinterpret_cast<const uint4*>(cols_m + static_cast<int64_t>(c0) * WORDS);
  for (int i = tid; i < TILE * VEC; i += TILE) cols[i / VEC][i % VEC] = csrc[i];

  uint4 row[VEC];
  const uint4* rsrc = reinterpret_cast<const uint4*>(rows_m + static_cast<int64_t>(r) * WORDS);
#pragma unroll
  for (int q = 0; q < VEC; ++q) row[q] = rsrc[q];
  const int lo = row_lo ? row_lo[r] : r;
  const int lim = min(bounds[r], n);
  __syncthreads();

  int32_t* out = words + (h * (TILE / 32) + warp) * TILE;
  unsigned mine = 0;
  for (int c = 0; c < TILE; ++c) {
    const int col = c0 + c;
    const bool hit = (hamming(row, cols[c]) <= tol) & (col > lo) & (col < lim);
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if ((c & 31) == lane) mine = word;
    if ((c & 31) == 31) out[c - 31 + lane] = static_cast<int32_t>(mine);
  }
}

}  // namespace

// row_lo may be null: the self-search's window c > r.  counts must be
// zeroed.  tol comes in clamped to [-1, 1024] (ops/hamming_cuda.py
// _clamp_tol), so the threshold 1024 - 2 tol stays in range.
extern "C" int vdf_band_counts(const void* rows, const void* cols,
                               const void* bounds, const void* row_lo,
                               const void* first_ct, const void* n_ct,
                               void* counts, int64_t row_tiles, int32_t slots,
                               int32_t n, int32_t tol, void* stream) {
  const int64_t blocks = row_tiles * ((slots + SEG - 1) / SEG);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t attr = cudaFuncSetAttribute(
      band_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // ham <= tol  <=>  dot >= 1024 - 2 tol
  band_counts_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(first_ct), static_cast<const int32_t*>(n_ct),
      static_cast<int32_t*>(counts), slots, n, 1024 - 2 * tol);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vdf_band_pack(const void* rows, const void* cols,
                             const void* bounds, const void* row_lo,
                             const void* hits, void* words, int64_t n_hits,
                             int32_t n, int32_t tol, void* stream) {
  if (n_hits > 0) {
    band_pack_kernel<<<static_cast<unsigned>(n_hits), TILE, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(row_lo),
        static_cast<const int32_t*>(hits), static_cast<int32_t*>(words), n, tol);
  }
  return static_cast<int>(cudaGetLastError());
}
