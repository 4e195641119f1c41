// Blockwise absmax int8 quantizer and its inverse, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jubatus_tpu/parallel/quantized.py:
//   quantize_int8   -> _quant_kernel    (per 32x512 tile: absmax,
//                      scale = max(absmax, 1e-30) / 127,
//                      q = clip(round_half_even(x / scale), -127, 127))
//   dequantize_int8 -> _dequant_kernel  (x = float(q) * scale[tile])
//
// Layout: x is a row-major [rows, cols] f32 array, rows % 32 == 0,
// cols % 512 == 0; scales are row-major [rows/32, cols/512].
//
// Bound on this card: memory.  The quantizer reads 4 bytes and writes 1
// byte per element (plus 4 bytes per 16384-element tile), the inverse
// reads 1 and writes 4; neither does enough arithmetic to matter.
//
// Design: the TPU kernel walks its grid in order with a whole tile in
// VMEM.  Here one CTA owns one tile (64 KiB of f32): 512 threads, thread t
// owns column t of the tile, so each of the 32 row loads is one coalesced
// 2 KiB transaction, and the tile's 32 values per thread stay in
// registers between the absmax pass and the store pass (one read of x).
// The absmax is reduced with warp shuffles, then across the 16 warps in
// shared memory.  Bitwise parity with numpy and the Pallas kernel needs
// IEEE division (not a multiply by the reciprocal), rintf's
// round-half-even, and no --use_fast_math; max is exact in any order.
// The inverse is an elementwise grid-stride pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK_R = 32;
constexpr int BLK_C = 512;
constexpr int WARPS = BLK_C / 32;

__global__ void __launch_bounds__(BLK_C)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ s, long long cols) {
  const long long nbc = cols / BLK_C;           // tiles per tile-row
  const long long tile = blockIdx.x;
  const long long bi = tile / nbc, bj = tile % nbc;
  const int t = threadIdx.x;
  const long long base = bi * BLK_R * cols + bj * BLK_C + t;

  float v[BLK_R];
  float m = 0.0f;
#pragma unroll
  for (int r = 0; r < BLK_R; ++r) {
    v[r] = x[base + r * cols];
    m = fmaxf(m, fabsf(v[r]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[WARPS];
  __shared__ float s_scale;
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  if (t == 0) {
    float a = warp_max[0];
    for (int i = 1; i < WARPS; ++i) a = fmaxf(a, warp_max[i]);
    const float scale = fmaxf(a, 1e-30f) / 127.0f;
    s_scale = scale;
    s[tile] = scale;
  }
  __syncthreads();
  const float scale = s_scale;
#pragma unroll
  for (int r = 0; r < BLK_R; ++r) {
    float y = rintf(v[r] / scale);
    y = fminf(fmaxf(y, -127.0f), 127.0f);
    q[base + r * cols] = (int8_t)y;
  }
}

__global__ void dequant_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               float* __restrict__ out, long long rows,
                               long long cols) {
  const long long n = rows * cols;
  const long long nbc = cols / BLK_C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / cols, c = i % cols;
    out[i] = (float)q[i] * s[(r / BLK_R) * nbc + c / BLK_C];
  }
}

}  // namespace

// Entry points: plain C, every pointer and the stream as void*, returning
// cudaGetLastError() after the launch.
extern "C" int quantize_int8_launch(const void* x, void* q, void* s,
                                    long long rows, long long cols,
                                    void* stream) {
  const long long tiles = (rows / BLK_R) * (cols / BLK_C);
  if (tiles > 0) {
    quant_kernel<<<(unsigned)tiles, BLK_C, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)s, cols);
  }
  return (int)cudaGetLastError();
}

extern "C" int dequantize_int8_launch(const void* q, const void* s, void* out,
                                      long long rows, long long cols,
                                      void* stream) {
  const long long n = rows * cols;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond this
    dequant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const float*)s, (float*)out, rows, cols);
  }
  return (int)cudaGetLastError();
}
