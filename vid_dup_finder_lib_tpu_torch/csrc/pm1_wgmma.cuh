// The int8 +/-1 tensor-core mainloops of band_counts_kernel (K2) and
// band_pack_kernel (K3), both in hamming_band.cu, and band_sweep_kernel
// (K4, band_sweep.cu), and the tile geometry of all three.
//
// Each packed bit expands to an int8 +/-1 (bit 1 -> +1, bit 0 -> -1), so
// dot(r, c) = 1024 - 2 * ham(r, c) exactly in int32 and ham <= tol is
// dot >= 1024 - 2 * tol.  A block (two warpgroups, 256 threads) expands its
// 128-row tile once into eight K slabs of 128 rows x 128 bytes, in the
// 128-byte swizzled layout wgmma's descriptors read.  Column tiles are read
// packed, one tile ahead into registers, so no int8 copy of the library
// reaches device memory.  Any bit order along K serves, as long as rows and
// columns expand alike.
//
// K3 and K4 run tile_products: the row tile is wgmma's A (warpgroup g its
// rows 64g ..), and each column tile is expanded one K slab at a time into
// a ring of two 16 KB slabs in shared memory, B of wgmma.m64n128k32 with
// both operands read from shared memory, two block barriers a slab.  Their
// accumulators are the D fragment: warp q of warpgroup g holds rows
// 64g + 16q + lane / 4 and (+8); d[4j + e] is row (+8 when e >= 2), column
// 8j + 2 (lane % 4) (+1 when e is odd).
//
// K2 runs column_tile: the row tile is B (N = 128) in shared memory, read
// only after the block's prologue, and warpgroup g's 64 columns of each
// column tile are A, expanded from packed bits straight into wgmma's A
// fragment registers (column_fragments).  Nothing is stored to shared
// memory and no block barrier runs in the tile loop; a warpgroup waits
// only on its own wgmma groups.  Its row tile is expanded in a K order of
// its own (expand_row_tile_quads), the one in which lane % 4 of a quad
// needs only words 8 (lane % 4) .. + 7 of its columns and the four bytes
// of a fragment register are four bits of one word a byte apart, so that
// two instructions expand them (pm1_plane; pm1x4, which K3 and K4 use,
// takes five).  Its accumulators are
// the transposed tile: d[4j + e] is column 64g + 16q + lane / 4 (+8 when
// e >= 2) of the column tile against row 8j + 2 (lane % 4) (+1 when e is
// odd) of the row tile.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vdf {

constexpr int TILE = 128;  // rows per row tile == columns per column tile
constexpr int WORDS = 32;  // 1024 storage bits as 32 x 32-bit words
constexpr int SEG = 32;                   // column tiles per block
constexpr int THREADS = 256;              // two warpgroups, 64 rows each
constexpr int SLAB = 128;                 // bytes of K per row of a slab (one swizzle atom row)
constexpr int SLABS = 1024 / SLAB;        // K = 1024 int8 values
constexpr int SLAB_BYTES = TILE * SLAB;   // 16 KB
constexpr int RING_BYTES = SLABS * SLAB_BYTES   // the expanded row tile
                           + 2 * SLAB_BYTES;    // the ring of column slabs
constexpr int ALIGN_SLACK = 1024;         // for the 1024-byte alignment of the slabs
constexpr int64_t TILE_U2 = static_cast<int64_t>(TILE) * (WORDS / 2);  // uint2 per packed tile

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

// The same with A from the registers a[4s .. 4s + 3], in each warp the
// fragment of mma.m16n8k32's A: a[4s] row lane / 4 at K bytes
// 4 (lane % 4) .. + 3, a[4s + 1] row + 8, a[4s + 2] and a[4s + 3] the same
// rows at K bytes 16 + 4 (lane % 4) .. (K2's column_tile).
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], const uint32_t (&a)[16], int s,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : VDF_D8(0), VDF_D8(8), VDF_D8(16), VDF_D8(24), VDF_D8(32), VDF_D8(40),
        VDF_D8(48), VDF_D8(56)
      : "r"(a[4 * s]), "r"(a[4 * s + 1]), "r"(a[4 * s + 2]), "r"(a[4 * s + 3]), "l"(db),
        "r"(scale_d));
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

// The first 1024-byte-aligned address of the dynamic shared memory: the
// expanded row tile (SLABS slabs), then the ring (2 slabs).
__device__ __forceinline__ uint8_t* aligned_slabs(uint8_t* smem_raw) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  return smem_raw + (((base + 1023u) & ~1023u) - base);
}

// The row tile at rows_m + r0 rows, expanded once.  Slab k holds words
// 4k .. 4k + 3 of a row, which are uint2 2k and 2k + 1.
__device__ __forceinline__ void expand_row_tile(uint8_t* a_s, const int32_t* rows_m,
                                                int64_t r0, int er, int eh) {
  const uint2* rsrc = reinterpret_cast<const uint2*>(rows_m + (r0 + er) * WORDS) + eh;
#pragma unroll
  for (int k = 0; k < SLABS; ++k) expand(a_s + k * SLAB_BYTES, er, eh, rsrc[2 * k]);
}

// This thread's share (row er, half eh) of one packed column tile.
__device__ __forceinline__ void load_tile(uint2 (&v)[SLABS], const uint2* src) {
#pragma unroll
  for (int k = 0; k < SLABS; ++k) v[k] = src[2 * k];
}

// d = the row tile . the column tile ``cur`` (already expanded into ring
// slot 0), through the slab ring; when ``more``, it leaves slab 0 of the
// next tile ``nxt`` expanded in ring slot 0.  Every thread of the block
// calls it; it returns with the products complete in d.
__device__ __forceinline__ void tile_products(int (&d)[64], uint64_t da, uint64_t db,
                                              uint8_t* b_s, int er, int eh,
                                              const uint2 (&cur)[SLABS],
                                              const uint2 (&nxt)[SLABS], bool more) {
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
    } else if (more) {
      expand(next, er, eh, nxt[0]);
    }
    fence_async_smem();
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_operands(d);
}

// Whether accumulator i of this thread passes the predicate
//     dot >= thresh  &&  lo < c  &&  c < hi
// for column tile c0, with w0 / w1 the (lo, hi) windows of its two rows and
// cq = 2 (lane % 4).
__device__ __forceinline__ bool pair_hit(const int (&d)[64], int i, int c0, int cq, int2 w0,
                                    int2 w1, int thresh) {
  const int c = c0 + 8 * (i >> 2) + cq + (i & 1);
  const int2 w = (i & 2) ? w1 : w0;
  return (d[i] >= thresh) & (c > w.x) & (c < w.y);
}

// This thread's count of hits in the tile; tiles inside both rows' windows
// skip the window test.
__device__ __forceinline__ int count_hits(const int (&d)[64], int c0, int cq, int2 w0,
                                          int2 w1, int thresh) {
  int cnt = 0;
  if (c0 > max(w0.x, w1.x) && c0 + TILE <= min(w0.y, w1.y)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) cnt += d[i] >= thresh;
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) cnt += pair_hit(d, i, c0, cq, w0, w1, thresh);
  }
  return cnt;
}

// -- K2: the column tile in wgmma's A fragment registers ---------------------

// Keeps the compiler from moving the fragment's writes past wgmma_fence.
__device__ __forceinline__ void fence_fragments(uint32_t (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(f[i])::"memory");
}

// Bit plane h (0 or 1) of the four bytes of v -> four int8 +/-1 (bit
// 1 -> +1): each byte 0xFF - 0xFE * bit, one LOP and one IMAD, where
// pm1x4 takes five instructions for its four bits.
__device__ __forceinline__ uint32_t pm1_plane(uint32_t v, int h) {
  return h == 0 ? (v & 0x01010101u) * 0xFFFFFF02u + 0xFFFFFFFFu
                : (v & 0x02020202u) * 0xFFFFFF81u + 0xFFFFFFFFu;
}

// K2's K order: K step s = 4i + kk (slab i, its 32-byte step kk), byte
// 16h + 4q + e of the step holds bit 8e + 2kk + h of word 8q + i.  So
// 16-byte chunk c of slab i's row holds bits c, c + 8, c + 16, c + 24 of
// words i, 8 + i, 16 + i and 24 + i, four bytes each, and thread (r, h)
// of the block expands chunks 4h .. 4h + 3 of every slab of row r.
__device__ __forceinline__ void expand_row_tile_quads(uint8_t* a_s, const int32_t* rows_m,
                                                      int64_t r0, int er, int eh) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(rows_m + (r0 + er) * WORDS);
  const int sw = er & 7;
#pragma unroll
  for (int i = 0; i < SLABS; ++i) {
    const uint32_t w0 = src[i], w1 = src[8 + i], w2 = src[16 + i], w3 = src[24 + i];
    uint8_t* row = a_s + i * SLAB_BYTES + er * SLAB;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * eh + cc;
      *reinterpret_cast<uint4*>(row + ((c ^ sw) << 4)) =
          make_uint4(pm1_plane(w0 >> c, 0), pm1_plane(w1 >> c, 0), pm1_plane(w2 >> c, 0),
                     pm1_plane(w3 >> c, 0));
    }
  }
}

// This thread's words of one packed column tile: w[i] = word 8q + i of
// its column m, w[8 + i] = that of column m + 8; src points at column m's
// uint4 2q.
__device__ __forceinline__ void load_columns(uint32_t (&w)[16], const uint4* src) {
  const uint4 a = src[0], b = src[1], c = src[8 * (WORDS / 4)], e = src[8 * (WORDS / 4) + 1];
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  w[8] = c.x, w[9] = c.y, w[10] = c.z, w[11] = c.w, w[12] = e.x, w[13] = e.y, w[14] = e.z,
  w[15] = e.w;
}

// The A fragments of the four K steps of slab i from word i of the two
// columns (w0 of column m, w1 of m + 8): step kk's a[0..3] in f[4kk ..].
__device__ __forceinline__ void column_fragments(uint32_t (&f)[16], uint32_t w0, uint32_t w1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t v0 = w0 >> (2 * kk), v1 = w1 >> (2 * kk);
    f[4 * kk + 0] = pm1_plane(v0, 0);
    f[4 * kk + 1] = pm1_plane(v1, 0);
    f[4 * kk + 2] = pm1_plane(v0, 1);
    f[4 * kk + 3] = pm1_plane(v1, 1);
  }
}

// One column tile: d = this warpgroup's 64 columns (words w) . the row tile
// (descriptor db of slab 0), slab by slab, the fragments of slab i in
// f[i % 2]: f[0] comes in holding slab 0's.  A fragment set is rewritten
// only after wgmma_wait says the group that read it is done.  When more,
// f[0] goes out holding slab 0 of the next tile (nw).  Returns with the
// last slab's group in flight.
__device__ __forceinline__ void column_tile(int (&d)[64], uint32_t (&f)[2][16],
                                            const uint32_t (&w)[16], const uint32_t (&nw)[16],
                                            bool more, uint64_t db) {
#pragma unroll
  for (int i = 0; i < SLABS; ++i) {
    uint32_t(&fi)[16] = f[i & 1];
    if (i > 0) column_fragments(fi, w[i], w[8 + i]);
    fence_fragments(fi);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SLAB / 32; ++kk) {
      wgmma_s8_rs(d, fi, kk, db + ((i * SLAB_BYTES + kk * 32) >> 4), (i | kk) != 0);
    }
    wgmma_commit();
    fence_operands(d);
    wgmma_wait<1>();  // slab i - 1's group is done: f[(i + 1) % 2] is free
  }
  if (more) column_fragments(f[0], nw[0], nw[8]);
}

// This thread's count of hits among its accumulators of column tile c0
// (column_tile's D fragment), cm = c0 + its first column, q = lane % 4:
// dot >= thresh and lo < c < hi of the pair's row, (lo, hi) = win[row].
// inside: the warpgroup's columns lie inside every row's window.
__device__ __forceinline__ int count_column_hits(const int (&d)[64], int cm, int q,
                                                 const int2* win, bool inside, int thresh) {
  int cnt = 0;
  if (inside) {
#pragma unroll
    for (int i = 0; i < 64; ++i) cnt += d[i] >= thresh;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int4 v = *reinterpret_cast<const int4*>(win + 8 * j + 2 * q);  // rows n, n + 1
      cnt += (d[4 * j + 0] >= thresh) & (cm > v.x) & (cm < v.y);
      cnt += (d[4 * j + 1] >= thresh) & (cm > v.z) & (cm < v.w);
      cnt += (d[4 * j + 2] >= thresh) & (cm + 8 > v.x) & (cm + 8 < v.y);
      cnt += (d[4 * j + 3] >= thresh) & (cm + 8 > v.z) & (cm + 8 < v.w);
    }
  }
  return cnt;
}

}  // namespace vdf
