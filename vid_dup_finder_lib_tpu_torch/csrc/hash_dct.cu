// Fused batch hash: centred 16x16x16 cubes x collapsed-DCT operator,
// sign, bitpack.  One kernel, hash_dct_kernel.
//
// Replaces the Pallas kernel vid_dup_finder_lib_tpu/ops/hash_pallas.py
// (_build): out[v, b] = sign(sum_k (cube[v, k] - 128) * D3[b, k]) for the
// 1000 kept DCT bins b (rows 1000..1023 of D3 are zero and give 0 bits),
// packed LSB-first, 32 bins per int32 word, row-major [B, 32] -- the bit
// layout of VideoHash.packed_u32.
//
// What bounds it on an H100: 2 * 1024 * 4096 = 8.4 MFLOP of fp32 FMA per
// video against 4 KB of cube input and 128 B of output, so it is an
// arithmetic-bound SGEMM (M = videos, N = 1024 bins, K = 4096).  The
// operator (16 MB) stays resident in L2 across blocks.  The sums must be
// true fp32: no TF32 and no tensor cores, because the signs of near-zero
// coefficients depend on the low mantissa bits (the f32-vs-f64 bound the
// tests pin is <= 2 bits per hash).
//
// Design: a classic register-tiled SGEMM.  A block computes a 128-video x
// 128-bin tile; each of its 256 threads holds an 8 x 8 accumulator in
// registers and runs plain FMAs over K in steps of 32, with both operand
// tiles staged in shared memory (cubes converted u8 -> f32 - 128 on the
// way in, k-major so the inner loop reads float4s).  The operator is
// stored k-major ([4096, 1024], columns in cube memory order t, y, x), so
// its tile loads are coalesced float4s.  The epilogue writes the signs of
// the tile to shared memory and each warp packs 32 consecutive bins of
// one video into one word with __ballot_sync, so the output is already in
// its final row-major layout.  Faster designs (wgmma on split-fp32
// operands, TMA, a persistent grid) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 4096;       // 16 * 16 * 16 cube voxels
constexpr int N_BINS = 1024;  // 1000 kept bins padded to 32 words
constexpr int BM = 128;       // videos per block
constexpr int BN = 128;       // bins per block
constexpr int BK = 32;        // contraction step
constexpr int TM = 8;         // videos per thread
constexpr int TN = 8;         // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(BM * BK == THREADS * 16, "one uint4 of cube bytes per thread");
static_assert(BN * BK == THREADS * 16, "four float4 of operator per thread");
static_assert(sizeof(float) * BK * BM >= BM * BN, "sign tile fits in As");

__global__ void __launch_bounds__(THREADS)
hash_dct_kernel(const uint8_t* __restrict__ cubes,
                const float* __restrict__ d3,  // [K, N_BINS], k-major
                int32_t* __restrict__ out,     // [batch, 32]
                int64_t batch) {
  __shared__ __align__(16) float As[BK][BM];  // centred cube values
  __shared__ __align__(16) float Bs[BK][BN];  // operator tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // bin group
  const int ty = tid / (BN / TN);  // video group
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // cube tile: thread loads 16 bytes (video a_m, k offset a_k)
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const bool a_ok = v0 + a_m < batch;
  const uint8_t* a_src = cubes + (v0 + a_m) * K + a_k;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 128 (u8 -> f32 - 128) rows of the video tile, stored k-major
    uint4 av = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
    if (a_ok) av = *reinterpret_cast<const uint4*>(a_src + k0);
    const uint32_t aw[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const uint32_t byte = (aw[q >> 2] >> (8 * (q & 3))) & 0xffu;
      As[a_k + q][a_m] = static_cast<float>(byte) - 128.f;
    }
    // operator tile: BK rows of 128 bins, coalesced float4 loads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tid + i * THREADS;
      const int kk = f / (BN / 4);
      const int nn = (f % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[kk][nn]) =
          *reinterpret_cast<const float4*>(d3 + static_cast<size_t>(k0 + kk) * N_BINS + n0 + nn);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // signs of the 128 x 128 tile into shared memory (reusing As) ...
  uint8_t* sign = reinterpret_cast<uint8_t*>(&As[0][0]);  // [BM][BN]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      sign[(ty * TM + i) * BN + tx * TN + j] = acc[i][j] > 0.f ? 1 : 0;
  __syncthreads();

  // ... then one ballot per (video, 32-bin word): lane = bit position
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int idx = warp; idx < BM * (BN / 32); idx += THREADS / 32) {
    const int m = idx / (BN / 32);
    const int w = idx % (BN / 32);
    const unsigned word = __ballot_sync(0xffffffffu, sign[m * BN + w * 32 + lane] != 0);
    if (lane == 0 && v0 + m < batch)
      out[(v0 + m) * (N_BINS / 32) + n0 / 32 + w] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" int vdf_hash_dct(const void* cubes, const void* d3, void* out,
                            int64_t batch, void* stream) {
  if (batch > 0) {
    const dim3 grid(static_cast<unsigned>((batch + BM - 1) / BM), N_BINS / BN);
    hash_dct_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(cubes), static_cast<const float*>(d3),
        static_cast<int32_t*>(out), batch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
