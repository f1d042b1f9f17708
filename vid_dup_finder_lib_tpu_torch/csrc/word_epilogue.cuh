// The word epilogue shared by band_pack_kernel (hamming_band.cu) and
// band_sweep_kernel (band_sweep.cu): wgmma's D fragment of one 128 x 128
// tile -> the tile's transposed bitpacked adjacency, word [w, c] bit b =
// row 32w + b, column c, int32[TILE / 32, TILE] (2 KB).
//
// Warp q of warpgroup g holds rows 64g + 16q + lane / 4 (+8), columns
// 8j + 2 (lane % 4) (+1), so word 2g + q / 2 takes its bits 16 (q % 2) ..
// 16 (q % 2) + 15 from that warp.  For each j, four ballots over the
// predicates of d[4j + e] give 8 rows x 4 columns each, interleaved by
// lane % 4; lane L keeps the four ballots of j = L / 2 and gathers every
// fourth bit into the 16-bit halves of its four columns 8j + 2m + L % 2,
// stored into a 2 KB shared tile in the output layout (one writer per
// half, no atomics).  The block then writes the tile's 2 KB with coalesced
// 8-byte stores.

#pragma once

#include "pm1_wgmma.cuh"

namespace vdf {

constexpr int WORD_ROWS = TILE / 32;                 // words per column of a tile
constexpr int WTILE_BYTES = WORD_ROWS * TILE * 4;    // one tile's words, 2 KB

static_assert(WTILE_BYTES == THREADS * 8, "one 8-byte store per thread writes a tile's words");

// Bits m, m + 4, ..., m + 28 of x -> bits 0 .. 7.
__device__ __forceinline__ uint32_t every_fourth(uint32_t x, int m) {
  x = (x >> m) & 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// For each 8-column group j, the four ballots over the predicates of
// d[4j + e]; lane L keeps those of j = L / 2 in kb.  WINDOWED tests each
// pair against its row's window (pair_hit), else only the threshold.
template <bool WINDOWED>
__device__ __forceinline__ void group_ballots(uint32_t (&kb)[4], const int (&d)[64], int jl,
                                              int c0, int cq, int2 w0, int2 w1, int thresh) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hit = WINDOWED ? pair_hit(d, 4 * j + e, c0, cq, w0, w1, thresh)
                                : d[4 * j + e] >= thresh;
      const uint32_t bal = __ballot_sync(0xffffffffu, hit);
      if (j == jl) kb[e] = bal;
    }
  }
}

// The words of the tile whose products are in d (column tile c0, this
// thread's windows w0 / w1 and cq = 2 (lane % 4), as pair_hit takes them),
// built in the shared tile wtile and written to dst[WORD_ROWS * TILE].
// Every thread of the block calls it.  It holds one barrier, between the
// shared tile's writes and its reads; the caller keeps another between this
// call's reads and the next call's writes (tile_products has several).
__device__ __forceinline__ void store_tile_words(const int (&d)[64], int c0, int cq, int2 w0,
                                                 int2 w1, int thresh, uint32_t* wtile,
                                                 int32_t* dst) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this warp's 16-bit half hh of word wd, and the columns 8 jl + 2m + e1
  // (m = 0 .. 3) whose halves this lane builds
  const int wd = 2 * (tid >> 7) + ((warp & 3) >> 1);
  const int hh = warp & 1;
  const int jl = lane >> 1;
  const int e1 = lane & 1;
  uint32_t kb[4] = {0u, 0u, 0u, 0u};
  // a tile inside the windows of all the warp's rows skips the window test
  if (__all_sync(0xffffffffu, c0 > max(w0.x, w1.x) && c0 + TILE <= min(w0.y, w1.y))) {
    group_ballots<false>(kb, d, jl, c0, cq, w0, w1, thresh);
  } else {
    group_ballots<true>(kb, d, jl, c0, cq, w0, w1, thresh);
  }
  const uint32_t top = e1 ? kb[1] : kb[0];  // rows 0 .. 7 of the warp's 16
  const uint32_t bot = e1 ? kb[3] : kb[2];  // rows 8 .. 15
  uint16_t* halves = reinterpret_cast<uint16_t*>(wtile);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = 8 * jl + 2 * m + e1;
    halves[(wd * TILE + c) * 2 + hh] =
        static_cast<uint16_t>(every_fourth(top, m) | (every_fourth(bot, m) << 8));
  }
  __syncthreads();
  reinterpret_cast<uint2*>(dst)[tid] = reinterpret_cast<const uint2*>(wtile)[tid];
}

}  // namespace vdf
