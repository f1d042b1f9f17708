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
// Design (the mainloop lives in pm1_wgmma.cuh, shared with
// band_sweep_kernel).  A block (two warpgroups, 256 threads) owns a run of up to SEG
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
#include "pm1_wgmma.cuh"

namespace {

using namespace vdf;

// -- band_counts_kernel: int8 +/-1 on the tensor cores (pm1_wgmma.cuh) -----

constexpr int SMEM = RING_BYTES + TILE * 8 + ALIGN_SLACK;  // slabs, win[], alignment

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
  uint8_t* a_s = aligned_slabs(smem_raw);                     // [SLABS][TILE][SLAB]
  uint8_t* b_s = a_s + SLABS * SLAB_BYTES;                    // [2][TILE][SLAB]
  int2* win = reinterpret_cast<int2*>(b_s + 2 * SLAB_BYTES);  // per row: (lo, hi)

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
  expand_row_tile(a_s, rows_m, r0, er, eh);

  const int ct0 = first_ct[rt];
  const uint2* cbase = reinterpret_cast<const uint2*>(cols_m) +
                       (static_cast<int64_t>(ct0) * TILE + er) * (WORDS / 2) + eh;
  uint2 cur[SLABS], nxt[SLABS];
  load_tile(cur, cbase + t0 * TILE_U2);
  expand(b_s, er, eh, cur[0]);
  fence_async_smem();
  __syncthreads();

  // this thread's accumulator rows and columns (the D fragment)
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
    const bool more = t + 1 < t1;
    if (more) load_tile(nxt, cbase + (t + 1) * TILE_U2);
    tile_products(d, da, db, b_s, er, eh, cur, nxt, more);
    const int cnt = __reduce_add_sync(0xffffffffu, count_hits(d, (ct0 + t) * TILE, cq, w0, w1, thresh));
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
