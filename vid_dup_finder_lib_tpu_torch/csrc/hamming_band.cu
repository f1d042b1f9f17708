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
// rows carry bounds = -1 (and row_lo = 2^30) and never match.
//
// What bounds them on an H100: the library is read as packed rows
// (128 B/hash) rather than the TPU's 1 KB/hash +/-1 matrix, so the sweep
// is bound by the integer pipe: 32 XOR + 32 POPC + 32 IADD per pair, and
// POPC issues at a quarter of the ALU rate.  At 1M hashes the band holds
// ~4.6e10 pairs.  Design: a block owns one 128 x 128 tile; the tile's
// 128 rows sit in shared memory and are read as warp-wide broadcasts,
// while each thread keeps one column's 32 words in registers, so global
// traffic is 16 KB + 16 KB per 16k pairs.  A tensor-core version (the
// +/-1 or b1 expansion in shared memory feeding mma) is later work.
//
// The TPU grid ran in order and carried a row tile's count across the
// band axis in its output block.  CUDA blocks run in any order, so every
// block writes its own (row tile, band slot) count and nothing is carried
// between blocks.  One 1-D launch covers the whole band: block b is row
// tile b / slots, band slot b % slots; blocks past a row tile's band
// (slot >= n_ct) write 0 and exit.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using vdf::TILE;
using vdf::VEC;
using vdf::WORDS;
using vdf::hamming;

__global__ void __launch_bounds__(TILE)
band_counts_kernel(const int32_t* __restrict__ rows_m,    // [row tiles * TILE, 32]
                   const int32_t* __restrict__ cols_m,    // [col tiles * TILE, 32]
                   const int32_t* __restrict__ bounds,    // [rows], -1 on pad rows
                   const int32_t* __restrict__ row_lo,    // [rows] or null (c > r)
                   const int32_t* __restrict__ first_ct,  // [row tiles]
                   const int32_t* __restrict__ n_ct,      // [row tiles]
                   int32_t* __restrict__ counts,          // [row tiles, slots]
                   int slots, int n, int tol) {
  const int64_t bid = blockIdx.x;
  const int64_t rt = bid / slots;
  const int s = static_cast<int>(bid % slots);
  const int tid = threadIdx.x;
  if (s >= n_ct[rt]) {  // uniform over the block
    if (tid == 0) counts[bid] = 0;
    return;
  }
  __shared__ uint4 rows[TILE][VEC];  // 16 KB: the row tile
  __shared__ int2 win[TILE];         // per row: (lo, min(bounds, n))
  __shared__ int wsum[TILE / 32];

  const int64_t r0 = rt * TILE;
  const int c = (first_ct[rt] + s) * TILE + tid;
  const uint4* rsrc = reinterpret_cast<const uint4*>(rows_m + r0 * WORDS);
  for (int i = tid; i < TILE * VEC; i += TILE) rows[i / VEC][i % VEC] = rsrc[i];
  win[tid] = make_int2(row_lo ? row_lo[r0 + tid] : static_cast<int>(r0) + tid,
                       min(bounds[r0 + tid], n));

  uint4 col[VEC];
  const uint4* csrc = reinterpret_cast<const uint4*>(cols_m + static_cast<int64_t>(c) * WORDS);
#pragma unroll
  for (int q = 0; q < VEC; ++q) col[q] = csrc[q];
  __syncthreads();

  int cnt = 0;
  for (int r = 0; r < TILE; ++r) {
    const int ham = hamming(col, rows[r]);
    const int2 w = win[r];
    cnt += (ham <= tol) & (c > w.x) & (c < w.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) wsum[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < TILE / 32; ++w) total += wsum[w];
    counts[bid] = total;
  }
}

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

// row_lo may be null: the self-search's window c > r.
extern "C" int vdf_band_counts(const void* rows, const void* cols,
                               const void* bounds, const void* row_lo,
                               const void* first_ct, const void* n_ct,
                               void* counts, int64_t n_row_tiles, int32_t slots,
                               int32_t n, int32_t tol, void* stream) {
  const int64_t blocks = n_row_tiles * slots;
  if (blocks > 0) {
    band_counts_kernel<<<static_cast<unsigned>(blocks), TILE, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(row_lo),
        static_cast<const int32_t*>(first_ct), static_cast<const int32_t*>(n_ct),
        static_cast<int32_t*>(counts), slots, n, tol);
  }
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
