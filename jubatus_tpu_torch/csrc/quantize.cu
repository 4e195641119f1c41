// Blockwise absmax int8 quantizer and its inverse, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of jubatus_tpu/parallel/quantized.py:
//   quantize_int8   -> _quant_kernel    (per 32x512 tile: absmax,
//                      scale = max(absmax, 1e-30) / 127,
//                      q = clip(round_half_even(x / scale), -127, 127))
//   dequantize_int8 -> _dequant_kernel  (x = float(q) * scale[tile])
//
// Layout: x is a row-major [rows, cols] f32 array, rows % 32 == 0,
// cols % 512 == 0; scales are row-major [rows/32, cols/512].  Both kernels
// also take n, the number of elements that exist: an element at flat index
// >= n reads as 0 and is never written.  With cols == 512 that is the v3
// wire's flat run (contiguous 16384-element blocks, the last one partial)
// without a zero-padded copy, which is what the JAX codec's padding does.
//
// Bound on this card: memory.  The quantizer reads 4 bytes and writes 1
// byte per element (plus 4 bytes per 16384-element tile), the inverse
// reads 1 and writes 4.  At a whole [32, 2^20] table (167.8 MB moved) the
// bound is 50 µs; at the MIX round's 80 tiles (6.5 MB) it is 2 µs, and
// what decides the time there is a launch, one round trip to device memory
// and the per-element arithmetic of the SMs that hold a tile.
//
// quant_kernel.  One CTA of 512 threads owns one tile and holds it in
// registers, read once with 16-byte loads, neighbouring threads on
// neighbouring 16 bytes.  The absmax reduces with max.NaN (a NaN anywhere
// in the tile makes the scale NaN, like numpy's max; fmaxf would drop it)
// by warp shuffles, then across warps through shared memory, where every
// warp reduces the warps' partials itself: one block barrier, no serial
// walk.  Each thread quantizes from registers and stores 4 int8 at once,
// so a warp's store is one whole 128-byte line.  A CTA whose tile lies
// wholly below n takes a path without per-element checks.  Splitting a
// tile over a cluster of 2 or 4 CTAs (partials exchanged through
// distributed shared memory) was slower at every tile count from 8 to
// 2048: the cluster barrier costs more than the split saves (PERF.md).
//
// The quotient x / scale must be IEEE's, rounded half to even, for bitwise
// parity with numpy and the Pallas kernel, and a division is the costliest
// step per element.  So each element first takes p = x * (1 / scale):
// |p - x / scale| <= 3 * 2^-24 * |x / scale| < 2^-16, since |x / scale|
// <= 127 * (1 + 2^-23).  When p lies farther than 2^-14 from every
// half-integer, rint(p) is rint(x / scale); otherwise (ties, near-ties,
// NaN) the element takes the IEEE division.  No --use_fast_math.
//
// dequant_kernel.  A warp owns 512 consecutive elements (one tile row
// segment, so one scale); each lane loads 16 int8 with one 16-byte load,
// the lanes swap words by shuffles so that each of the warp's four float4
// stores writes 512 contiguous bytes (with each lane storing its own 64
// bytes, every store instruction would leave its lines three quarters
// unwritten, and device memory took them far slower), and the stores
// stream (st.global.cs).
// The scale index comes from 32-bit arithmetic once per thread.  The grid
// covers the array in one pass; the tail is written element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK_R = 32;
constexpr int BLK_C = 512;
constexpr int TILE4 = BLK_R * BLK_C / 4;   // float4 per tile
constexpr int ROW4 = BLK_C / 4;            // float4 per tile row
constexpr int Q_THREADS = 512;
constexpr int V = TILE4 / Q_THREADS;       // float4 per thread
constexpr int Q_WARPS = Q_THREADS / 32;
constexpr int DQ_THREADS = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return max_nan(max_nan(fabsf(v.x), fabsf(v.y)),
                 max_nan(fabsf(v.z), fabsf(v.w)));
}

// v / scale rounded half to even, clipped to [-127, 127], as a byte;
// rcp = 1 / scale (see the note above)
__device__ __forceinline__ uint32_t q8(float v, float scale, float rcp) {
  const float p = v * rcp;
  float y = rintf(p);
  if (!(fabsf(p - y) <= 0.5f - 0x1p-14f)) y = rintf(v / scale);
  y = fminf(fmaxf(y, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)y;
}

__device__ __forceinline__ uint32_t q8x4(float4 v, float scale, float rcp) {
  return q8(v.x, scale, rcp) | (q8(v.y, scale, rcp) << 8) |
         (q8(v.z, scale, rcp) << 16) | (q8(v.w, scale, rcp) << 24);
}

// CONTIG: cols == 512, so a tile is one contiguous run
template <bool CONTIG>
__global__ void __launch_bounds__(Q_THREADS)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ s, unsigned nbc, long long cols,
             long long n) {
  const int t = threadIdx.x;
  const unsigned tile = blockIdx.x;
  // flat index of the tile's first element, and of its float4 j
  long long base;
  if (CONTIG) {
    base = (long long)tile * (BLK_R * BLK_C);
  } else {
    const unsigned bi = tile / nbc, bj = tile - bi * nbc;
    base = (long long)bi * BLK_R * cols + (long long)bj * BLK_C;
  }
  auto at = [&](int j) -> long long {
    return CONTIG ? base + 4 * j : base + (j / ROW4) * cols + (j % ROW4) * 4;
  };
  const bool full = at(TILE4 - 1) + 4 <= n;

  float4 v[V];
  if (full) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = *reinterpret_cast<const float4*>(x + at(t + k * Q_THREADS));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long f = at(t + k * Q_THREADS);
      if (f + 4 <= n) {
        v[k] = *reinterpret_cast<const float4*>(x + f);
      } else {
        v[k].x = f < n ? x[f] : 0.0f;
        v[k].y = f + 1 < n ? x[f + 1] : 0.0f;
        v[k].z = f + 2 < n ? x[f + 2] : 0.0f;
        v[k].w = 0.0f;                   // f + 3 >= n here
      }
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) m = max_nan(m, absmax4(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[Q_WARPS];
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  m = warp_max[t & (Q_WARPS - 1)];
#pragma unroll
  for (int off = Q_WARPS / 2; off > 0; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = max_nan(m, 1e-30f) / 127.0f;
  const float rcp = 1.0f / scale;
  if (t == 0) s[tile] = scale;

  if (full) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      *reinterpret_cast<uint32_t*>(q + at(t + k * Q_THREADS)) =
          q8x4(v[k], scale, rcp);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long f = at(t + k * Q_THREADS);
      const uint32_t w = q8x4(v[k], scale, rcp);
      if (f + 4 <= n) {
        *reinterpret_cast<uint32_t*>(q + f) = w;
      } else {
        for (int e = 0; e < 3; ++e)
          if (f + e < n) q[f + e] = (int8_t)(w >> (8 * e));
      }
    }
  }
}

__device__ __forceinline__ float4 dq4(int w, float scale) {
  return make_float4((float)(int8_t)w * scale, (float)(int8_t)(w >> 8) * scale,
                     (float)(int8_t)(w >> 16) * scale,
                     (float)(int8_t)(w >> 24) * scale);
}

// A warp owns elements [512 g, 512 g + 512); lane l loads bytes 16 l ..
// 16 l + 15 of them.  Store k of lane l writes elements 128 k + 4 l .. + 3,
// which are word l & 3 of lane 8 k + (l >> 2).  g is 32-bit: n < 2^41.
__global__ void __launch_bounds__(DQ_THREADS)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ out, unsigned nbc, long long n) {
  const unsigned gw = (blockIdx.x * DQ_THREADS + threadIdx.x) >> 5;
  const long long wbase = (long long)gw * 512;
  if (wbase >= n) return;                // the whole warp
  const int l = threadIdx.x & 31;
  const unsigned row = gw / nbc;         // one row segment of 512
  const float scale = s[(row >> 5) * nbc + (gw - row * nbc)];
  const long long i = wbase + 16 * l;
  int4 w = make_int4(0, 0, 0, 0);
  if (i + 16 <= n) {
    w = *reinterpret_cast<const int4*>(q + i);
  } else if (i < n) {
    uint32_t b[4] = {0, 0, 0, 0};
    for (int e = 0; e < 16 && i + e < n; ++e)
      b[e >> 2] |= (uint32_t)(uint8_t)q[i + e] << (8 * (e & 3));
    w = make_int4((int)b[0], (int)b[1], (int)b[2], (int)b[3]);
  }
  const int sel = l & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = 8 * k + (l >> 2);
    const int x0 = __shfl_sync(0xffffffffu, w.x, src);
    const int x1 = __shfl_sync(0xffffffffu, w.y, src);
    const int x2 = __shfl_sync(0xffffffffu, w.z, src);
    const int x3 = __shfl_sync(0xffffffffu, w.w, src);
    const float4 o = dq4(sel == 0 ? x0 : sel == 1 ? x1 : sel == 2 ? x2 : x3,
                         scale);
    const long long f = wbase + 128 * k + 4 * l;
    if (f + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(out + f), o);
    } else {
      if (f < n) out[f] = o.x;
      if (f + 1 < n) out[f + 1] = o.y;
      if (f + 2 < n) out[f + 2] = o.z;
    }
  }
}

}  // namespace

// Entry points: plain C, every pointer and the stream as void*, returning
// the launch's CUDA error (0 when nothing was launched).  x, q and out must
// be 16-byte aligned; n <= rows * cols; for cols != 512, n == rows * cols.

extern "C" int quantize_int8_launch(const void* x, void* q, void* s,
                                    long long rows, long long cols,
                                    long long n, void* stream) {
  const long long tiles = (rows / BLK_R) * (cols / BLK_C);
  if (tiles == 0 || n == 0) return 0;
  const unsigned nbc = (unsigned)(cols / BLK_C);
  const cudaStream_t st = (cudaStream_t)stream;
  if (cols == BLK_C) {
    quant_kernel<true><<<(unsigned)tiles, Q_THREADS, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)s, nbc, cols, n);
  } else {
    quant_kernel<false><<<(unsigned)tiles, Q_THREADS, 0, st>>>(
        (const float*)x, (int8_t*)q, (float*)s, nbc, cols, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int dequantize_int8_launch(const void* q, const void* s, void* out,
                                      long long rows, long long cols,
                                      long long n, void* stream) {
  (void)rows;
  if (n == 0) return 0;
  const long long threads = (n + 511) / 512 * 32;
  const unsigned blocks = (unsigned)((threads + DQ_THREADS - 1) / DQ_THREADS);
  dequant_kernel<<<blocks, DQ_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)s, (float*)out,
      (unsigned)(cols / BLK_C), n);
  return (int)cudaGetLastError();
}
