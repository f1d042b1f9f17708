// Whole-band sweep of the self-search: the counterpart of the Pallas kernel
// vid_dup_finder_lib_tpu/ops/hamming_band.py _build_band.
//
// For each row tile of a range and every column tile of that tile's band,
// band_sweep_kernel writes the tile's match count and its transposed
// bitpacked adjacency: word [w, c] holds rows 32w .. 32w+31 of column c,
// bit b = row 32w + b (band_pack_kernel's layout, so one decoder reads
// both).  The predicate is band_counts_kernel's self-search one:
//     ham(r, c) <= tol  &&  c > r  &&  c < min(bounds[r], n)
// over all 1024 storage bits; pad rows carry bounds = -1 and never match.
//
// Layout.  counts: int32[row tiles of the range, slots], every entry
// written (0 past the row tile's n_ct, as the TPU kernel zeroes its stale
// slots).  words: int32[band tiles of the range, TILE / 32, TILE], packed
// by band-tile offset: tile t of row tile rt0 + r is tile_off[r] + t.  The
// words of a tile whose count is 0 are not written (nothing reads them).
// The caller cuts the row tiles into ranges whose words fit a memory budget.
//
// What bounds it on an H100: the same work as band_counts_kernel, one
// 1024-deep dot product per in-band pair on the int8 tensor cores (47.5 ms
// at chip_smoke.py's 1M library), plus 2 KB of words per hit tile.
//
// Design.  band_counts_kernel's mainloop (pm1_wgmma.cuh) and grid: a block
// of two warpgroups expands its 128-row tile once into int8 +/-1 and walks
// a run of up to SEG column tiles of its band through wgmma.m64n128k32.
// Only the epilogue is new.  The block owns the whole 128 x 128 tile, so
// its count goes straight to counts[r, t] (a warp reduction, eight warp
// sums in shared memory, no atomics).  A tile with hits then rebuilds its
// words from the D fragment and writes its 2 KB (store_tile_words,
// word_epilogue.cuh, shared with band_pack_kernel).
//
// Why runs of SEG tiles rather than one block per whole band: at 1M hashes
// a range that fits the word budget holds a few hundred row tiles, too few
// blocks to fill 132 SMs, and bands grow with their rows' durations, so
// whole-band blocks would finish unevenly.

#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_wgmma.cuh"
#include "word_epilogue.cuh"

namespace {

using namespace vdf;

constexpr int WARPS = THREADS / 32;
constexpr int SMEM = RING_BYTES + TILE * 8 + WTILE_BYTES + WARPS * 4 + ALIGN_SLACK;

__global__ void __launch_bounds__(THREADS, 1)
band_sweep_kernel(const int32_t* __restrict__ packed,    // [n_pad, 32]
                  const int32_t* __restrict__ bounds,    // [n_pad], -1 on pad rows
                  const int32_t* __restrict__ first_ct,  // [row tiles]
                  const int32_t* __restrict__ n_ct,      // [row tiles]
                  const int64_t* __restrict__ tile_off,  // [row tiles of the range]
                  int32_t* __restrict__ counts,          // [row tiles of the range, slots]
                  int32_t* __restrict__ words,           // [band tiles of the range, 4, TILE]
                  int rt0, int slots, int n, int thresh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = aligned_slabs(smem_raw);                           // [SLABS][TILE][SLAB]
  uint8_t* b_s = a_s + SLABS * SLAB_BYTES;                          // [2][TILE][SLAB]
  int2* win = reinterpret_cast<int2*>(b_s + 2 * SLAB_BYTES);        // per row: (lo, hi)
  uint32_t* wtile = reinterpret_cast<uint32_t*>(win + TILE);        // [WORD_ROWS][TILE]
  int* wsum = reinterpret_cast<int*>(wtile + WORD_ROWS * TILE);     // per warp

  const int segs = (slots + SEG - 1) / SEG;
  const int r = static_cast<int>(blockIdx.x / segs);
  const int t0 = static_cast<int>(blockIdx.x % segs) * SEG;
  const int rt = rt0 + r;
  const int tid = threadIdx.x;
  const int nct = n_ct[rt];
  const int t1 = min(t0 + SEG, nct);
  int32_t* cnt_out = counts + static_cast<int64_t>(r) * slots;
  for (int t = max(t0, nct) + tid; t < min(t0 + SEG, slots); t += THREADS) cnt_out[t] = 0;
  if (t0 >= t1) return;  // uniform over the block

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int er = tid >> 1;  // expansion: this thread's row / column of a tile
  const int eh = tid & 1;   // ... and its half of each 16-byte slab row
  const int64_t r0 = static_cast<int64_t>(rt) * TILE;
  if (tid < TILE) win[tid] = make_int2(static_cast<int>(r0) + tid, min(bounds[r0 + tid], n));
  expand_row_tile(a_s, packed, r0, er, eh);

  const int ct0 = first_ct[rt];
  const uint2* cbase = reinterpret_cast<const uint2*>(packed) +
                       (static_cast<int64_t>(ct0) * TILE + er) * (WORDS / 2) + eh;
  uint2 cur[SLABS], nxt[SLABS];
  load_tile(cur, cbase + t0 * TILE_U2);
  expand(b_s, er, eh, cur[0]);
  fence_async_smem();
  __syncthreads();

  // this thread's accumulator rows and columns (the D fragment)
  const int qr = wg * 64 + (warp & 3) * 16 + (lane >> 2);
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

    const int c0 = (ct0 + t) * TILE;
    const int cnt = __reduce_add_sync(0xffffffffu, count_hits(d, c0, cq, w0, w1, thresh));
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += wsum[w];
    if (tid == 0) cnt_out[t] = total;
    if (total) {  // uniform over the block
      store_tile_words(d, c0, cq, w0, w1, thresh, wtile,
                       words + (tile_off[r] + t) * (WORD_ROWS * TILE));
    }
    // wsum and wtile are written again only after the next tile's
    // products, whose barriers every thread passes first
#pragma unroll
    for (int k = 0; k < SLABS; ++k) cur[k] = nxt[k];
  }
}

}  // namespace

// tol comes in clamped to [-1, 1024] (ops/hamming_cuda.py _clamp_tol).
extern "C" int vdf_band_sweep(const void* packed, const void* bounds,
                              const void* first_ct, const void* n_ct,
                              const void* tile_off, void* counts, void* words,
                              int64_t n_rows, int32_t rt0, int32_t slots,
                              int32_t n, int32_t tol, void* stream) {
  const int64_t blocks = n_rows * ((slots + SEG - 1) / SEG);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t attr = cudaFuncSetAttribute(
      band_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // ham <= tol  <=>  dot >= 1024 - 2 tol
  band_sweep_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(bounds),
      static_cast<const int32_t*>(first_ct), static_cast<const int32_t*>(n_ct),
      static_cast<const int64_t*>(tile_off), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(words), rt0, slots, n, 1024 - 2 * tol);
  return static_cast<int>(cudaGetLastError());
}
