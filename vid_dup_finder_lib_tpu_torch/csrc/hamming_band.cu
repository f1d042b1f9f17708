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
// take 0.04 ms.  So the tensor cores bound it.  Each packed bit expands to
// an int8 +/-1 (bit 1 -> +1, bit 0 -> -1), and
//     dot(r, c) = 1024 - 2 * ham(r, c)
// exactly in int32, so ham <= tol is dot >= 1024 - 2 * tol.  Any bit order
// serves as long as rows and columns expand alike.
//
// What held it at half that bound (53% of it, 4.20 us per 128 x 128
// tile per SM against the 2.24 us the tensor cores need) was shared
// memory.  Its first design kept the row tile expanded in shared memory
// as A and expanded each column tile there too, one 16 KB K slab at a
// time into a ring of two, as B of wgmma.m64n128k32 with both operands in
// shared memory.  At the int8 peak (4,096 MACs a cycle per SM) one slab's
// 512 tensor-core cycles then carried 48 KB of operand reads (each
// warpgroup its 8 KB of A and all 16 KB of B) and 16 KB of expansion
// stores: 128 B a cycle, the SM's whole shared-memory bandwidth.  Two
// block barriers a slab, 16 a tile, locked the warpgroups together, so
// both ran their epilogues while no wgmma was in flight.
//
// Design (pm1_wgmma.cuh column_tile).  A block (two warpgroups, 256
// threads) owns a run of up to SEG column tiles of one row tile's band.
// It expands its 128-row tile once, into 128 KB of shared memory: eight K
// slabs of 128 rows x 128 bytes in the 128-byte swizzled layout that
// wgmma's descriptors read, B of every product (N = 128).  The column
// tile is A and never touches shared memory: warpgroup g takes columns
// 64g .. 64g + 63 of each tile, and each thread reads a quarter of the
// packed words of its two columns (16 registers, the next tile's 16 one
// tile ahead) and expands them straight into wgmma's A fragment registers,
// one K slab's four k32 steps at a time, in a ring of two fragment sets:
// a set is rewritten only after wgmma.wait_group says the group that read
// it is done.  Shared memory then carries B's reads alone, 32 KB a slab
// (64 B a cycle at the peak), and the row tile is read-only after the
// block's one barrier, so the tile loop has none: each warpgroup waits
// only on its own wgmma groups, and one warpgroup's epilogue overlaps the
// other's products.  The rows and columns expand in a K order of their
// own (pm1_wgmma.cuh expand_row_tile_quads), the one in which a thread
// needs only its quarter of each column's words and four bits a byte apart
// fill one fragment register: one LOP and one IMAD (pm1_plane), where the
// nibble expansion of K3 and K4 (pm1x4) takes five, and the 1M sweep
// 54-58 ms against 59-62.  The accumulators are the transposed tile,
// D[column, row]: after a tile each thread compares its
// 64 with the threshold, skipping the window test when the warpgroup's 64
// columns lie inside every row's window (the row tile's largest lo and
// smallest hi, reduced once per block), else testing each pair against its
// row's (lo, min(bounds, n)) in shared memory, and the warps add their
// counts into the (row tile, slot) entry with one atomic each, skipping
// zero counts; the wrapper zeroes the output.  Library reads stay packed:
// no int8 copy of the library goes to device memory.  On an NVIDIA H100
// 80GB HBM3 at 700 W the 1M sweep takes 53-54 ms, 88-89% of the bound
// (2.5 us a tile per SM), and 8M hashes 84% (chip_smoke.py).
//
// The TPU grid ran in order and carried a row tile's count across the
// band axis in its output block.  CUDA blocks run in any order, so each
// block writes its own entries and nothing is carried between blocks.
// One launch covers a slab of consecutive row tiles [rt0, rt0 + row_tiles)
// and writes counts relative to it, [row_tiles, slots] with slots the
// slab's widest band: the wrapper walks a large library slab by slab, so
// the counts never outgrow a fixed budget (ops/hamming_cuda.py
// count_slabs).  The grid covers the slab's [row tiles, runs of SEG slots]
// rectangle; a block past its row tile's band exits at once.  Rows, windows
// and band metadata are indexed by the global row tile.
//
// band_pack_kernel on an H100.  Its work is the same dot product for the
// 128 x 128 pairs of each hit tile, and 2 KB of words per tile; the
// tensor cores bound it too (0.017 us per tile).  It runs the same
// mainloop.  The hit list is row-major, so on a library with many
// duplicates consecutive hits share their row tile: the list is cut into
// chunks of consecutive hits, one block each, and a block expands a row
// tile only when it differs from the previous hit's, with the next hit's
// column tile one ahead in registers.  The wrapper makes a chunk
// ceil(H / SMs) hits, at most 32: scattered hits spread over all SMs, many
// hits give long runs.  The words come from wgmma's D fragment through
// store_tile_words (word_epilogue.cuh, shared with band_sweep_kernel), for
// every tile of the list, also one that turns out to hold no match.  On an
// NVIDIA H100 80GB HBM3 at 700 W a list of 65,808 band tiles of the 1M
// library takes 2.3-2.4 ms, 4.6-4.9 us per tile per SM beside
// band_counts_kernel's 2.5 (chip_smoke.py, tools/k3_times.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_wgmma.cuh"
#include "word_epilogue.cuh"

namespace {

using namespace vdf;

// -- band_counts_kernel: int8 +/-1 on the tensor cores, the column tile in
// -- registers (pm1_wgmma.cuh column_tile) ---------------------------------

// the row tile, win[], the four warps' (max lo, min hi), alignment
constexpr int COUNTS_SMEM = SLABS * SLAB_BYTES + TILE * 8 + 4 * 8 + ALIGN_SLACK;

__global__ void __launch_bounds__(THREADS, 1)
band_counts_kernel(const int32_t* __restrict__ rows_m,    // [row tiles * TILE, 32]
                   const int32_t* __restrict__ cols_m,    // [col tiles * TILE, 32]
                   const int32_t* __restrict__ bounds,    // [rows], -1 on pad rows
                   const int32_t* __restrict__ row_lo,    // [rows] or null (c > r)
                   const int32_t* __restrict__ first_ct,  // [row tiles]
                   const int32_t* __restrict__ n_ct,      // [row tiles]
                   int32_t* __restrict__ counts,          // [slab row tiles, slots], zeroed
                   int rt0, int slots, int n, int thresh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = aligned_slabs(smem_raw);                     // [SLABS][TILE][SLAB]
  int2* win = reinterpret_cast<int2*>(a_s + SLABS * SLAB_BYTES);  // per row: (lo, hi)
  int2* span = win + TILE;                                    // per warp: (max lo, min hi)

  const int segs = (slots + SEG - 1) / SEG;
  const int r = static_cast<int>(blockIdx.x / segs);  // row tile of the slab
  const int rt = rt0 + r;                             // ... and of the state
  const int t0 = static_cast<int>(blockIdx.x % segs) * SEG;
  const int t1 = min(t0 + SEG, n_ct[rt]);
  if (t0 >= t1) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int64_t r0 = static_cast<int64_t>(rt) * TILE;

  // this thread's columns of every column tile, m and m + 8, and its
  // quarter q of their words; the first tile's are loaded first
  const int m = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int q = lane & 3;
  const int ct0 = first_ct[rt];
  const uint4* cbase = reinterpret_cast<const uint4*>(cols_m) +
                       (static_cast<int64_t>(ct0) * TILE + m) * (WORDS / 4) + 2 * q;
  constexpr int TILE_U4 = TILE * (WORDS / 4);
  uint32_t w[16], nw[16];
  uint32_t f[2][16];
  load_columns(w, cbase + static_cast<int64_t>(t0) * TILE_U4);

  if (tid < TILE) {
    const int2 v = make_int2(row_lo ? row_lo[r0 + tid] : static_cast<int>(r0) + tid,
                             min(bounds[r0 + tid], n));
    win[tid] = v;
    const int lo = __reduce_max_sync(0xffffffffu, v.x);
    const int hi = __reduce_min_sync(0xffffffffu, v.y);
    if (lane == 0) span[tid >> 5] = make_int2(lo, hi);
  }
  expand_row_tile_quads(a_s, rows_m, r0, tid >> 1, tid & 1);
  column_fragments(f[0], w[0], w[8]);
  fence_async_smem();
  __syncthreads();  // the one block barrier: the row tile, win[] and span[] are written

  const int2 s0 = span[0], s1 = span[1], s2 = span[2], s3 = span[3];
  const int max_lo = max(max(s0.x, s1.x), max(s2.x, s3.x));
  const int min_hi = min(min(s0.y, s1.y), min(s2.y, s3.y));
  const uint64_t db = smem_desc(a_s);
  int d[64];
  for (int t = t0; t < t1; ++t) {
    const bool more = t + 1 < t1;
    if (more) load_columns(nw, cbase + static_cast<int64_t>(t + 1) * TILE_U4);
    column_tile(d, f, w, nw, more, db);
    wgmma_wait<0>();
    fence_operands(d);
    const int c0 = (ct0 + t) * TILE + wg * 64;
    const bool inside = c0 > max_lo && c0 + 64 <= min_hi;  // uniform over the warpgroup
    const int cnt = __reduce_add_sync(
        0xffffffffu, count_column_hits(d, c0 + (m & 63), q, win, inside, thresh));
    if (lane == 0 && cnt) atomicAdd(counts + static_cast<int64_t>(r) * slots + t, cnt);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = nw[i];
  }
}

// -- band_pack_kernel: the same products, then the word epilogue -----------

constexpr int PACK_SMEM = RING_BYTES + TILE * 8 + WTILE_BYTES + ALIGN_SLACK;

// Block b owns hits [b * chunk, min((b + 1) * chunk, n_hits)).
__global__ void __launch_bounds__(THREADS, 1)
band_pack_kernel(const int32_t* __restrict__ rows_m,  // [row tiles * TILE, 32]
                 const int32_t* __restrict__ cols_m,  // [col tiles * TILE, 32]
                 const int32_t* __restrict__ bounds,  // [rows], -1 on pad rows
                 const int32_t* __restrict__ row_lo,  // [rows] or null (c > r)
                 const int32_t* __restrict__ hits,    // [H, 2]: row tile, col tile
                 int32_t* __restrict__ words,         // [H, TILE / 32, TILE]
                 int64_t n_hits, int chunk, int n, int thresh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = aligned_slabs(smem_raw);                           // [SLABS][TILE][SLAB]
  uint8_t* b_s = a_s + SLABS * SLAB_BYTES;                          // [2][TILE][SLAB]
  int2* win = reinterpret_cast<int2*>(b_s + 2 * SLAB_BYTES);        // per row: (lo, hi)
  uint32_t* wtile = reinterpret_cast<uint32_t*>(win + TILE);        // [WORD_ROWS][TILE]

  const int64_t h0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t h1 = min(h0 + chunk, n_hits);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int er = tid >> 1;  // expansion: this thread's row / column of a tile
  const int eh = tid & 1;   // ... and its half of each 16-byte slab row
  const uint2* cbase = reinterpret_cast<const uint2*>(cols_m) + er * (WORDS / 2) + eh;
  uint2 cur[SLABS], nxt[SLABS];
  load_tile(cur, cbase + hits[2 * h0 + 1] * TILE_U2);
  expand(b_s, er, eh, cur[0]);  // made visible by the first row tile's fence and barrier

  // this thread's accumulator rows and columns (the D fragment)
  const int qr = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint64_t da = smem_desc(a_s + wg * 64 * SLAB);
  const uint64_t db = smem_desc(b_s);
  int2 w0 = make_int2(0, 0), w1 = w0;
  int rt = -1;  // the row tile expanded in a_s

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  for (int64_t h = h0; h < h1; ++h) {
    const int hrt = hits[2 * h];
    const int ct = hits[2 * h + 1];
    const bool more = h + 1 < h1;
    if (more) load_tile(nxt, cbase + hits[2 * h + 3] * TILE_U2);
    if (hrt != rt) {  // uniform over the block
      // every warpgroup's products of the previous tile are complete and
      // every thread has read its windows: store_tile_words' barrier
      rt = hrt;
      const int64_t r0 = static_cast<int64_t>(rt) * TILE;
      if (tid < TILE) {
        win[tid] = make_int2(row_lo ? row_lo[r0 + tid] : static_cast<int>(r0) + tid,
                             min(bounds[r0 + tid], n));
      }
      expand_row_tile(a_s, rows_m, r0, er, eh);
      fence_async_smem();
      __syncthreads();
      w0 = win[qr];
      w1 = win[qr + 8];
    }
    tile_products(d, da, db, b_s, er, eh, cur, nxt, more);
    // wtile is written again only after the next tile's products, whose
    // barriers every thread passes first
    store_tile_words(d, ct * TILE, cq, w0, w1, thresh, wtile, words + h * (WORD_ROWS * TILE));
#pragma unroll
    for (int k = 0; k < SLABS; ++k) cur[k] = nxt[k];
  }
}

}  // namespace

// Row tiles [rt0, rt0 + row_tiles) of the state into counts[row_tiles,
// slots]; no row tile of the slab may have a band wider than slots.
// row_lo may be null: the self-search's window c > r.  counts must be
// zeroed.  tol comes in clamped to [-1, 1024] (ops/hamming_cuda.py
// _clamp_tol), so the threshold 1024 - 2 tol stays in range.
extern "C" int vdf_band_counts(const void* rows, const void* cols,
                               const void* bounds, const void* row_lo,
                               const void* first_ct, const void* n_ct,
                               void* counts, int64_t row_tiles, int32_t rt0,
                               int32_t slots, int32_t n, int32_t tol, void* stream) {
  const int64_t blocks = row_tiles * ((slots + SEG - 1) / SEG);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t attr = cudaFuncSetAttribute(
      band_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, COUNTS_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // ham <= tol  <=>  dot >= 1024 - 2 tol
  band_counts_kernel<<<static_cast<unsigned>(blocks), THREADS, COUNTS_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(first_ct), static_cast<const int32_t*>(n_ct),
      static_cast<int32_t*>(counts), rt0, slots, n, 1024 - 2 * tol);
  return static_cast<int>(cudaGetLastError());
}

// Every tile of hits gets its 2 KB of words; block b takes hits
// [b * chunk, (b + 1) * chunk) (ops/hamming_cuda.py pack_chunk).  tol comes
// in clamped like vdf_band_counts'.
extern "C" int vdf_band_pack(const void* rows, const void* cols,
                             const void* bounds, const void* row_lo,
                             const void* hits, void* words, int64_t n_hits,
                             int32_t chunk, int32_t n, int32_t tol, void* stream) {
  if (n_hits <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_hits + chunk - 1) / chunk;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t attr = cudaFuncSetAttribute(
      band_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PACK_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  band_pack_kernel<<<static_cast<unsigned>(blocks), THREADS, PACK_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(row_lo),
      static_cast<const int32_t*>(hits), static_cast<int32_t*>(words), n_hits, chunk, n,
      1024 - 2 * tol);
  return static_cast<int>(cudaGetLastError());
}
