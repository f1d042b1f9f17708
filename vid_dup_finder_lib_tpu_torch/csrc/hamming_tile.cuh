// Tile geometry of the sweep kernels (hamming_band.cu, band_sweep.cu, via
// pm1_wgmma.cuh), and the packed-row Hamming distance of band_pack_kernel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vdf {

constexpr int TILE = 128;  // rows per row tile == columns per column tile
constexpr int WORDS = 32;  // 1024 storage bits as 32 x 32-bit words
constexpr int VEC = WORDS / 4;  // the same row as 8 x uint4

// Hamming distance over all 1024 storage bits of a row held in registers
// and one read through a pointer (shared memory in every caller).
__device__ __forceinline__ int hamming(const uint4 (&a)[VEC], const uint4* b) {
  int ham = 0;
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const uint4 v = b[q];
    ham += __popc(a[q].x ^ v.x) + __popc(a[q].y ^ v.y) +
           __popc(a[q].z ^ v.z) + __popc(a[q].w ^ v.w);
  }
  return ham;
}

}  // namespace vdf
