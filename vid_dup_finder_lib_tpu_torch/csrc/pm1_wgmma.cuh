// The int8 +/-1 tensor-core mainloop shared by band_counts_kernel and
// band_pack_kernel (hamming_band.cu) and band_sweep_kernel (band_sweep.cu),
// and the tile geometry of all three.
//
// Each packed bit expands in shared memory to an int8 +/-1 (bit 1 -> +1,
// bit 0 -> -1), so dot(r, c) = 1024 - 2 * ham(r, c) exactly in int32 and
// ham <= tol is dot >= 1024 - 2 * tol.  A block (two warpgroups, 256
// threads) expands its 128-row tile once into eight K slabs of 128 rows x
// 128 bytes, in the 128-byte swizzled layout wgmma's descriptors read, and
// runs column tiles through a ring of two 16 KB slabs: while warpgroup w's
// wgmma.m64n128k32 (s8 x s8 -> s32) runs on slab k over its 64 rows, the
// block expands slab k + 1 (tile_products).  Column tiles are read packed,
// one tile ahead into registers (load_tile), so no int8 copy of the library
// reaches device memory.
//
// The accumulators are wgmma's D fragment: warp q of warpgroup g holds rows
// 64g + 16q + lane / 4 and (+8); d[4j + e] is row (+8 when e >= 2), column
// 8j + 2 (lane % 4) (+1 when e is odd).

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

}  // namespace vdf
