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
// caller cuts the row tiles into ranges whose words fit a memory budget.
//
// Design.  Thread t owns row rt * TILE + t, its 32 words in registers, and
// warp w's ballot over one column's predicate is word [w, c].  A block
// walks a run of up to SEG column tiles of its row tile's band, staging
// each 16 KB column tile in shared memory with double-buffered cp.async:
// tile t + 1 is in flight while tile t is compared (the CUDA form of the
// TPU kernel's make_async_copy pair, hamming_band.py:88-112).  Columns are
// read from shared memory as warp-wide broadcasts.  Lane c % 32 keeps
// column c's word; the warp stores 32 columns at a time, coalesced, and
// sums __popc of what it stores; the block adds its four warps' sums.
//
// Why runs of SEG tiles rather than one block per whole band: at 1M hashes
// a range that fits the word budget holds a few hundred row tiles, too few
// blocks to fill 132 SMs, and bands grow with their rows' durations, so
// whole-band blocks would finish unevenly.
//
// What bounds it on an H100: the integer pipe, as for band_counts_kernel
// (32 XOR + 32 POPC + 32 IADD per pair), plus one ballot per column and
// 2 KB of words stored per tile.  Tensor cores are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

using vdf::TILE;
using vdf::VEC;
using vdf::WORDS;
using vdf::hamming;

constexpr int SEG = 32;  // column tiles per block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying one 16 KB column tile into a shared buffer, as one group.
__device__ __forceinline__ void stage(uint4 (*dst)[VEC], const uint4* src, int tid) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int i = tid + k * TILE;
    cp_async16(&dst[i / VEC][i % VEC], src + i);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(TILE)
band_sweep_kernel(const int32_t* __restrict__ packed,    // [n_pad, 32]
                  const int32_t* __restrict__ bounds,    // [n_pad], -1 on pad rows
                  const int32_t* __restrict__ first_ct,  // [row tiles]
                  const int32_t* __restrict__ n_ct,      // [row tiles]
                  const int64_t* __restrict__ tile_off,  // [row tiles of the range]
                  int32_t* __restrict__ counts,          // [row tiles of the range, slots]
                  int32_t* __restrict__ words,           // [band tiles of the range, 4, TILE]
                  int rt0, int slots, int n, int tol) {
  const int segs = (slots + SEG - 1) / SEG;
  const int r = blockIdx.x / segs;
  const int t0 = (blockIdx.x % segs) * SEG;
  const int rt = rt0 + r;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nct = n_ct[rt];
  const int t1 = min(t0 + SEG, nct);
  int32_t* cnt_out = counts + static_cast<int64_t>(r) * slots;
  for (int t = max(t0, nct) + tid; t < min(t0 + SEG, slots); t += TILE) cnt_out[t] = 0;
  if (t0 >= t1) return;  // uniform over the block

  __shared__ uint4 cols[2][TILE][VEC];  // 32 KB: two column tiles
  __shared__ int wsum[TILE / 32];

  const int row = rt * TILE + tid;
  uint4 a[VEC];
  const uint4* rsrc = reinterpret_cast<const uint4*>(packed + static_cast<int64_t>(row) * WORDS);
#pragma unroll
  for (int q = 0; q < VEC; ++q) a[q] = rsrc[q];
  const int lim = min(bounds[row], n);

  const int ct0 = first_ct[rt];
  const uint4* base = reinterpret_cast<const uint4*>(packed) + static_cast<int64_t>(ct0) * TILE * VEC;
  stage(cols[0], base + static_cast<int64_t>(t0) * TILE * VEC, tid);
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      // cols[buf ^ 1] was last read in iteration t - 1, before its closing
      // barrier, so it is free
      stage(cols[buf ^ 1], base + static_cast<int64_t>(t + 1) * TILE * VEC, tid);
      cp_async_wait<1>();  // this thread's copies of tile t have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every other thread's

    const int c0 = (ct0 + t) * TILE;
    int32_t* out = words + ((tile_off[r] + t) * (TILE / 32) + warp) * TILE;
    unsigned mine = 0;
    int cnt = 0;
    for (int c = 0; c < TILE; ++c) {
      const int col = c0 + c;
      const bool hit = (hamming(a, cols[buf][c]) <= tol) & (col > row) & (col < lim);
      const unsigned word = __ballot_sync(0xffffffffu, hit);
      if ((c & 31) == lane) mine = word;
      if ((c & 31) == 31) {
        out[c - 31 + lane] = static_cast<int32_t>(mine);
        cnt += __popc(mine);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();  // wsum is complete and no thread reads cols[buf] again
    if (tid == 0) cnt_out[t] = wsum[0] + wsum[1] + wsum[2] + wsum[3];
  }
}

}  // namespace

extern "C" int vdf_band_sweep(const void* packed, const void* bounds,
                              const void* first_ct, const void* n_ct,
                              const void* tile_off, void* counts, void* words,
                              int64_t n_rows, int32_t rt0, int32_t slots,
                              int32_t n, int32_t tol, void* stream) {
  const int64_t blocks = n_rows * ((slots + SEG - 1) / SEG);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > 0) {
    band_sweep_kernel<<<static_cast<unsigned>(blocks), TILE, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(packed), static_cast<const int32_t*>(bounds),
        static_cast<const int32_t*>(first_ct), static_cast<const int32_t*>(n_ct),
        static_cast<const int64_t*>(tile_off), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(words), rt0, slots, n, tol);
  }
  return static_cast<int>(cudaGetLastError());
}
