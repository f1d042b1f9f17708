// Batch hash: centred 16x16x16 cubes -> separable 3D DCT-II of the kept
// 10x10x10 corner -> sign -> bitpack.  One kernel, hash_dct_kernel.
//
// Replaces the Pallas kernel vid_dup_finder_lib_tpu/ops/hash_pallas.py
// (_build), which folded the whole 3D DCT into one [1024, 4096] operator
// for the TPU's 128 x 128 matrix unit.  Out[v] holds the signs of the 1000
// kept DCT bins b = i*100 + j*10 + k (i along t, j along x, k along y),
// packed LSB-first, 32 bins per int32 word, row-major [B, 32] -- the bit
// layout of VideoHash.packed_u32; bins 1000..1023 are 0.
//
// Why the separable form is allowed: the DCT-II is separable and the hash
// keeps only the low 10 rows of each axis, so the three contractions of
// ops/golden.py dct3_golden (y, then x, then t) with the 10 kept rows of
// the DCT-II matrix, D f32[10, 16], compute the same coefficients as the
// collapsed operator with 82,560 multiply-adds per cube instead of
// 4,194,304.  Both are fp32 sums in some order; the tests hold this order,
// like the collapsed one, to the f64 golden model within <= 2 bits per
// hash (the bound tests/test_golden_model.py pins for the JAX package).
// Flat cubes are the exception for every fp32 order: all their AC
// coefficients are exactly zero in exact arithmetic, so their AC signs are
// rounding noise (bin 0, an exact integer sum, is right; a cube of 128s
// gives all-zero words).
//
// What bounds it on an H100: the fp32 pipe, just above the bytes.  The
// least fp32 work of the function splits each 16-point pass into even and
// odd halves (DCT-II row k is even or odd about the middle): 16 FADDs and
// 80 FMAs per pass, 516 passes, 49,536 FMA-pipe instructions per cube --
// 0.097 ms for 65,536 cubes at the 67 TFLOP/s fp32 rate, against 0.083 ms
// for their 4 KB of input and 128 B of output.  This kernel does not split:
// it runs 160 FMAs per pass, 82,560 per cube (0.161 ms at that rate), in
// the order the CPU tests emulate.  The sums are plain fp32 FMAs in a fixed order:
// no TF32, no tensor cores, no reassociation (the signs of near-zero
// coefficients depend on the low mantissa bits).
//
// Design.  Blocks of two warps; each warp hashes two cubes, lane = (cube
// h = lane / 16, frame t = lane % 16).
//   0.   The warp stages its two cubes in shared memory with coalesced
//        16-byte loads, frame planes padded by one word so that the 32
//        lanes' column reads hit 32 banks.
//   1+2. A lane contracts y for four columns x at once (the four bytes of
//        one word):  A[x][k] = sum_y D[k][y] * (frame[y][x] - 128),
//        then folds each column straight into the x contraction:
//        B[j][k] += D[j][x] * A[x][k], so neither intermediate leaves
//        registers (100 accumulators for B).
//   3.   The lanes write B[t][j][k] to shared memory over the staged cubes,
//        (j, k)-major with t fastest, and 200 units (cube, j, k) over the
//        32 lanes contract t:  C[i] = sum_t D[i][t] * B[t][j][k]; the sign
//        of each bin goes to a byte in shared memory.
//   4.   32 ballots per cube gather the bytes into the output words; lane w
//        keeps word w and the warp stores 128 coalesced bytes per cube.
// Every coefficient chain runs in ascending order from 0 (the order the
// CPU tests emulate).  The block copies the [10, 16] factor into shared
// memory transposed, column n = D[0..9][n] in 48 bytes, and each step
// loads the column it needs into registers with vector loads: one load
// feeds 40 FFMAs in stage 1, 100 in stage 2 and 10 in stage 3.  Two
// alternatives ran slower on the H100: coefficients as __constant__ FFMA
// operands (a distinct constant per FFMA, and the constant cache serves
// about one a clock per SM), and a persistent grid (the compiler then keeps
// all 160 coefficients in registers across the loop, and spills).  The
// loads are volatile for the same reason.  Each u8 -> f32 conversion is
// one byte permute into the mantissa of 2^23 and one subtraction of
// 2^23 + 128, both exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N = 16;           // cube edge
constexpr int KEEP = 10;        // kept DCT rows per axis
constexpr int CUBE = N * N * N; // 4096 bytes
constexpr int WORDS = 32;       // output words per cube
constexpr int WARPS = 2;        // warps per block
constexpr int MIN_BLOCKS = 4;  // blocks per SM: up to 255 registers a thread
constexpr int XS = 4;           // columns x contracted together in stage 1 (one word)
constexpr int JK = KEEP * KEEP; // (j, k) units per cube
constexpr int BSTRIDE = 20;     // floats per (j, k) row of B: 16 t + pad, conflict-free float4 reads
constexpr int PLANE = N * N / 4 + 1;  // words per staged frame: 64 + 1 pad, conflict-free column reads
constexpr int STAGED = N * PLANE;     // words per staged cube (1040, 16 banks apart)
constexpr int DSTRIDE = 12;           // floats per column n of the factor: D[0..9][n] + pad
static_assert(2 * STAGED <= 2 * JK * BSTRIDE, "the staged pair fits in B's space");
static_assert(N % XS == 0 && 4 % XS == 0, "column groups lie inside one word");

// byte q of word w, minus 128, exactly
__device__ __forceinline__ float centred(uint32_t w, int q) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | q)) - 8388736.0f;
}

// D[0..9][n] from the block's transposed copy of the factor, into
// registers.  The loads are volatile so that the compiler issues them where
// they stand and does not keep all 160 coefficients live across the kernel.
__device__ __forceinline__ void column(const float* dt, int n, float (&d)[KEEP]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dt + n * DSTRIDE));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]) : "r"(a));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4 + 16];"
               : "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]) : "r"(a));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2 + 32];" : "=f"(d[8]), "=f"(d[9]) : "r"(a));
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
hash_dct_kernel(const uint8_t* __restrict__ cubes, const float* __restrict__ dct,
                int32_t* __restrict__ out, int64_t batch) {
  // per warp: the staged cube pair, then (once read) B of both cubes
  __shared__ __align__(16) float b_s[WARPS][2 * JK * BSTRIDE];  // B per cube, [(j, k)][t]
  __shared__ uint8_t sign_s[WARPS][2 * WORDS * 32];             // a byte per bin
  __shared__ __align__(16) float dt[N * DSTRIDE];               // dt[n][k] = D[k][n]

  for (int i = threadIdx.x; i < KEEP * N; i += WARPS * 32) dt[(i % N) * DSTRIDE + i / N] = dct[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * WARPS + warp;  // this warp's cube pair
  if (2 * p >= batch) return;  // uniform over the warp
  const int h = lane >> 4;  // stages 1+2: this lane's cube of the pair ...
  const int t = lane & 15;  // ... and its frame
  float* bw = b_s[warp];
  uint32_t* staged = reinterpret_cast<uint32_t*>(bw);  // [2][N][PLANE]: (cube, t), then (y, x / 4)
  uint8_t* sg = sign_s[warp];
  if (lane < WORDS * 32 - 1000) {  // bins 1000..1023 are 0
    sg[1000 + lane] = 0;
    sg[WORDS * 32 + 1000 + lane] = 0;
  }

  // stage the pair: 512 coalesced 16-byte loads, each a (cube, t, y) row;
  // a missing second cube is 128s
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int i = lane + 32 * k;  // (cube, t, y)
    const int64_t v = 2 * p + (i >> 8);
    uint4 row = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
    if (v < batch) row = reinterpret_cast<const uint4*>(cubes + v * CUBE)[i & 255];
    uint32_t* dst = staged + (i >> 8) * STAGED + ((i >> 4) & 15) * PLANE + (i & 15) * 4;
    dst[0] = row.x; dst[1] = row.y; dst[2] = row.z; dst[3] = row.w;
  }
  __syncwarp();

  // stages 1 and 2: contract y for XS columns at once (each coefficient
  // loaded once, used XS times), then fold each column into x
  const uint32_t* frame = staged + h * STAGED + t * PLANE;
  float b[KEEP][KEEP];  // B[j][k] of frame t
#pragma unroll
  for (int j = 0; j < KEEP; ++j)
#pragma unroll
    for (int k = 0; k < KEEP; ++k) b[j][k] = 0.f;
#pragma unroll
  for (int x0 = 0; x0 < N; x0 += XS) {
    float a[XS][KEEP];
#pragma unroll
    for (int xs = 0; xs < XS; ++xs)
#pragma unroll
      for (int k = 0; k < KEEP; ++k) a[xs][k] = 0.f;
#pragma unroll
    for (int y = 0; y < N; ++y) {
      const uint32_t w = frame[y * 4 + (x0 >> 2)];
      float px[XS];
#pragma unroll
      for (int xs = 0; xs < XS; ++xs) px[xs] = centred(w, (x0 & 3) + xs);
      float d[KEEP];
      column(dt, y, d);
#pragma unroll
      for (int k = 0; k < KEEP; ++k)
#pragma unroll
        for (int xs = 0; xs < XS; ++xs) a[xs][k] = fmaf(d[k], px[xs], a[xs][k]);
    }
#pragma unroll
    for (int xs = 0; xs < XS; ++xs) {
      float d[KEEP];
      column(dt, x0 + xs, d);
#pragma unroll
      for (int j = 0; j < KEEP; ++j)
#pragma unroll
        for (int k = 0; k < KEEP; ++k) b[j][k] = fmaf(d[j], a[xs][k], b[j][k]);
    }
  }
  __syncwarp();  // every lane has read the staged pair: B may overwrite it
  float* bh = bw + h * JK * BSTRIDE;
#pragma unroll
  for (int j = 0; j < KEEP; ++j)
#pragma unroll
    for (int k = 0; k < KEEP; ++k) bh[(j * KEEP + k) * BSTRIDE + t] = b[j][k];
  __syncwarp();

  // stage 3: units u = (cube, j, k) contract t; sign byte of each bin
#pragma unroll
  for (int r0 = 0; r0 < 2 * JK; r0 += 32) {
    const int u = r0 + lane;
    if (u >= 2 * JK) break;
    const int uh = u >= JK;
    const int jk = u - uh * JK;
    const float4* src = reinterpret_cast<const float4*>(bw + (uh * JK + jk) * BSTRIDE);
    float bt[N];
#pragma unroll
    for (int r = 0; r < N / 4; ++r) {
      const float4 f = src[r];
      bt[4 * r] = f.x; bt[4 * r + 1] = f.y; bt[4 * r + 2] = f.z; bt[4 * r + 3] = f.w;
    }
    float c[KEEP];
#pragma unroll
    for (int i = 0; i < KEEP; ++i) c[i] = 0.f;
#pragma unroll
    for (int tt = 0; tt < N; ++tt) {
      float d[KEEP];
      column(dt, tt, d);
#pragma unroll
      for (int i = 0; i < KEEP; ++i) c[i] = fmaf(d[i], bt[tt], c[i]);
    }
    uint8_t* s = sg + uh * WORDS * 32 + jk;
#pragma unroll
    for (int i = 0; i < KEEP; ++i) s[i * JK] = c[i] > 0.f;
  }
  __syncwarp();

  // stage 4: lane = bit position of a ballot; lane w keeps word w
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uint32_t mine = 0;
#pragma unroll 8
    for (int w = 0; w < WORDS; ++w) {
      const uint32_t word = __ballot_sync(0xffffffffu, sg[c * WORDS * 32 + w * 32 + lane] != 0);
      if (w == lane) mine = word;
    }
    if (2 * p + c < batch) out[(2 * p + c) * WORDS + lane] = static_cast<int32_t>(mine);
  }
}

}  // namespace

// cubes u8[B, 16, 16, 16] (t, y, x), dct f32[10, 16], out i32[B, 32]
extern "C" int vdf_hash_dct(const void* cubes, const void* dct, void* out,
                            int64_t batch, void* stream) {
  if (batch > 0) {
    const int64_t pairs = (batch + 1) / 2;
    hash_dct_kernel<<<static_cast<unsigned>((pairs + WARPS - 1) / WARPS), WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(cubes), static_cast<const float*>(dct),
        static_cast<int32_t*>(out), batch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
