// Sequential online train step of the linear classifier, for Hopper (sm_90a).
//
// Replaces train_scan_impl in jubatus_tpu/models/classifier.py: the strict
// per-datum lax.scan that the JAX package compiles into one XLA loop (the
// default "sequential" microbatch mode).  Methods: perceptron, PA, PA1,
// PA2 (weights only) and CW, AROW, NHERD (weights + diagonal covariance).
//
// State: w, cov [L, D] f32 (cov unused by the first four methods),
// counts [L] i32, active [L] u8 (torch.bool).  Batch: indices [B, K] i32,
// values [B, K] f32, labels [B] i32, mask [B] f32 (0 = padding datum) —
// views of the packed [idx | val | label | mask] arena.
//
// Bound on this card: latency, not bytes or operations.  Each datum reads
// L*K weights (+ 2K covariances) and writes at most 4K values, a few KiB,
// but datum b+1 must see datum b's writes, so the B datums run one after
// another.  The kernel is one persistent CTA that walks the microbatch in
// order: the whole batch costs one launch instead of ~20 small kernels per
// datum.  Per datum:
//   1. stage idx/val in shared memory;
//   2. scores: one warp per label row, lanes stride over K, shuffle sum;
//   3. thread 0: counts/active, rival argmax (lowest index on ties, row 0
//      when no label is active — jnp.argmax's rules), margin, |x|^2 and,
//      for the weights-only methods, the step size;
//   4. CW family: gather cov[y, idx] and cov[r, idx], thread 0 reduces the
//      confidence v and derives alpha and the covariance factor;
//   5. threads over K: w[y|r, idx] += ... with atomicAdd (duplicate
//      columns accumulate) and cov[y|r, idx] = new value, written only by
//      the LAST occurrence of a column in the datum — XLA CPU's scatter-set
//      order, so the padding entries (index 0, value 0) overwrite a real
//      column-0 feature's covariance update exactly as the reference does.
// A __syncthreads() closes every datum.  w and cov are read and written
// by the same CTA, so they are not __restrict__ (no read-only cache path).  Arithmetic is f32 throughout and
// follows the reference expressions term by term; sums run in another
// order than XLA's, so results agree to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Method { PERCEPTRON = 0, PA = 1, PA1 = 2, PA2 = 3, CW = 4, AROW = 5,
              NHERD = 6 };

constexpr int THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
train_scan_kernel(float* w, float* cov, int32_t* counts, uint8_t* active,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ values,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ mask, int B, int K, int L,
                  long long D, int method, float c) {
  extern __shared__ float smem[];
  float* s_val = smem;                       // [K]
  float* s_cy = s_val + K;                   // [K]
  float* s_cr = s_cy + K;                    // [K]
  float* s_score = s_cr + K;                 // [L]
  int* s_idx = (int*)(s_score + L);          // [K]
  int* s_cnt = s_idx + K;                    // [L]
  int* s_act = s_cnt + L;                    // [L]

  __shared__ int s_y, s_r, s_ok;
  __shared__ float s_a, s_g, s_margin;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const bool has_cov = method >= CW;

  for (int l = tid; l < L; l += blockDim.x) {
    s_cnt[l] = counts[l];
    s_act[l] = active[l] ? 1 : 0;
  }

  for (int b = 0; b < B; ++b) {
    if (!(mask[b] > 0.0f)) continue;   // padding datum: a no-op step
    const int32_t* idx_b = indices + (long long)b * K;
    const float* val_b = values + (long long)b * K;
    for (int k = tid; k < K; k += blockDim.x) {
      s_idx[k] = idx_b[k];
      s_val[k] = val_b[k];
    }
    __syncthreads();

    // 2. scores s[l] = sum_k w[l, idx[k]] * val[k]
    for (int l = warp; l < L; l += nwarps) {
      const float* wl = w + (long long)l * D;
      float acc = 0.0f;
      for (int k = lane; k < K; k += 32) acc += wl[s_idx[k]] * s_val[k];
      acc = warp_sum(acc);
      if (lane == 0) s_score[l] = acc;
    }
    __syncthreads();

    // 3. scalar decisions
    if (tid == 0) {
      const int y = labels[b];
      s_act[y] = 1;
      s_cnt[y] += 1;
      int r = 0;
      float best = -INFINITY;
      for (int l = 0; l < L; ++l) {
        if (l == y || !s_act[l]) continue;
        if (s_score[l] > best) { best = s_score[l]; r = l; }
      }
      const bool has_rival = isfinite(best);
      const float margin = s_score[y] - best;
      float sqn = 0.0f;
      for (int k = 0; k < K; ++k) sqn += s_val[k] * s_val[k];
      const bool ok = has_rival && sqn > 0.0f;
      float a = 0.0f;
      if (method == PERCEPTRON) {
        a = (ok && margin <= 0.0f) ? 1.0f : 0.0f;
      } else if (method == PA || method == PA1 || method == PA2) {
        const float loss = 1.0f - margin;
        float tau;
        if (method == PA) tau = loss / (2.0f * sqn);
        else if (method == PA1) tau = fminf(c, loss / (2.0f * sqn));
        else tau = loss / (2.0f * sqn + 0.5f / c);
        a = (ok && loss > 0.0f) ? tau : 0.0f;
      }
      s_y = y;
      s_r = r;
      s_ok = ok ? 1 : 0;
      s_a = a;
      s_margin = margin;
    }
    __syncthreads();
    if (!s_ok) continue;   // uniform: no table changes for this datum
    const int y = s_y, r = s_r;
    float* wy = w + (long long)y * D;
    float* wr = w + (long long)r * D;

    if (!has_cov) {
      const float a = s_a;
      for (int k = tid; k < K; k += blockDim.x) {
        const float x = s_val[k];
        atomicAdd(&wy[s_idx[k]], a * x);
        atomicAdd(&wr[s_idx[k]], -a * x);
      }
      __syncthreads();
      continue;
    }

    // 4. CW family: gather the two covariance rows
    float* cy_row = cov + (long long)y * D;
    float* cr_row = cov + (long long)r * D;
    for (int k = tid; k < K; k += blockDim.x) {
      s_cy[k] = cy_row[s_idx[k]];
      s_cr[k] = cr_row[s_idx[k]];
    }
    __syncthreads();
    if (tid == 0) {
      float v = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float x2 = s_val[k] * s_val[k];
        v += x2 * (s_cy[k] + s_cr[k]);
      }
      const float m = s_margin;
      float a, g;
      if (method == AROW) {
        const float beta = 1.0f / (v + c);
        const bool gate = m < 1.0f;
        a = gate ? fmaxf(0.0f, 1.0f - m) * beta : 0.0f;
        g = gate ? beta : 0.0f;               // ncy = cy - g*cy*cy*x2
      } else if (method == CW) {
        const float phi = c;
        const float t = 1.0f + 2.0f * phi * m;
        const float inner = t * t - 8.0f * phi * (m - phi * v);
        const float gamma = (-t + sqrtf(fmaxf(inner, 0.0f))) /
                            (4.0f * phi * fmaxf(v, 1e-12f));
        a = fmaxf(0.0f, gamma);
        g = 2.0f * a * phi;                   // ncy = 1/(1/cy + g*x2)
      } else {  // NHERD
        const bool gate = m < 1.0f;
        a = gate ? fmaxf(0.0f, 1.0f - m) / (v + c) : 0.0f;
        g = gate ? (2.0f * c + c * c * v) : 0.0f;   // ncy = cy/(1+g*x2)
      }
      s_a = a;
      s_g = g;
    }
    __syncthreads();

    // 5. updates
    const float a = s_a, g = s_g;
    for (int k = tid; k < K; k += blockDim.x) {
      const int j = s_idx[k];
      const float x = s_val[k], x2 = x * x;
      const float cy = s_cy[k], cr = s_cr[k];
      float ncy, ncr;
      if (method == AROW) {
        ncy = cy - g * cy * cy * x2;
        ncr = cr - g * cr * cr * x2;
      } else if (method == CW) {
        ncy = 1.0f / (1.0f / fmaxf(cy, 1e-12f) + g * x2);
        ncr = 1.0f / (1.0f / fmaxf(cr, 1e-12f) + g * x2);
      } else {
        const float denom = 1.0f + g * x2;
        ncy = cy / denom;
        ncr = cr / denom;
      }
      bool last = true;
      for (int k2 = k + 1; k2 < K; ++k2)
        if (s_idx[k2] == j) { last = false; break; }
      if (last) {
        cy_row[j] = ncy;
        cr_row[j] = ncr;
      }
      atomicAdd(&wy[j], a * cy * x);
      atomicAdd(&wr[j], -a * cr * x);
    }
    __syncthreads();
  }

  __syncthreads();
  for (int l = tid; l < L; l += blockDim.x) {
    counts[l] = s_cnt[l];
    active[l] = (uint8_t)s_act[l];
  }
}

}  // namespace

// Plain C entry point: every pointer and the stream as void*; returns
// cudaGetLastError() after the launch.
extern "C" int train_scan_launch(void* w, void* cov, void* counts,
                                 void* active, const void* indices,
                                 const void* values, const void* labels,
                                 const void* mask, int B, int K, int L,
                                 long long D, int method, float c,
                                 void* stream) {
  const size_t smem = (size_t)(4 * K + 3 * L) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        train_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  train_scan_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (float*)w, (float*)cov, (int32_t*)counts, (uint8_t*)active,
      (const int32_t*)indices, (const float*)values, (const int32_t*)labels,
      (const float*)mask, B, K, L, D, method, c);
  return (int)cudaGetLastError();
}
