// Sequential online train step of linear regression (PA, PA1, PA2), for
// Hopper (sm_90a).
//
// Replaces train_scan_impl in jubatus_tpu/models/regression.py (:32): the
// per-datum lax.scan that the JAX package compiles into one XLA loop for
// every train microbatch.
//
// State: w [D] f32.  Batch: indices [B, K] i32, values [B, K] f32,
// targets [B] f32, mask [B] f32 (0 = padding datum) — views of the packed
// [idx | val | target | mask] arena.  For each datum i in order, with w as
// datum i-1 left it:
//
//   pred = sum_k w[idx[i,k]] * val[i,k]      err  = target[i] - pred
//   loss = |err| - eps                       sqn  = sum_k val[i,k]^2
//   tau  = PA: loss/sqn   PA1: min(c, loss/sqn)   PA2: loss/(sqn + 0.5/c)
//   tau  = 0 unless mask[i] > 0, loss > 0 and sqn > 0
//   w[idx[i,k]] += sign(err) * tau * val[i,k]   for every k
//
// Duplicate columns within a datum accumulate (w.at[idx].add adds each
// entry); padding entries (index 0, value 0) add a signed zero to w[0].
//
// What bounds it: datum i+1 reads what datum i wrote, so the B datums run
// one after another.  Each reads K weights and writes at most K — a few
// hundred bytes — so the kernel is bound by the latency of the per-datum
// chain (a gather from device memory, two warp reductions, a division, a
// read-modify-write), far above its bytes bound.  This is the simple first
// version: making the chain shorter (a ring of prefetched slots with
// store forwarding, as csrc/train_scan.cu does for the classifier) is
// later work.
//
// Design: one warp walks the batch.  Lane l holds entries k = l, l+32, ...
//   1. gather: each lane sums w[idx]*val and val*val over its entries in
//      ascending k; a butterfly reduction gives every lane the same pred and
//      sqn (IEEE addition commutes, so the lanes agree bitwise).
//   2. step: every lane computes the same tau.
//   3. scatter, one 32-entry chunk at a time: lanes holding the same column
//      find each other with __match_any_sync; the group's lowest lane adds
//      the group's deltas to w[col] one by one in ascending k (the order of
//      the reference's scatter-add) and stores once.  A __syncwarp after
//      each chunk orders its stores before the next chunk's loads (a column
//      repeated across chunks is read again) and before the next datum's
//      gather.  No atomics: two launches on one input give the same bits.
// The first chunk of the next datum's idx and val, and its target and
// mask, do not depend on w, so they are loaded while the current datum
// runs.  Arithmetic is float32 with IEEE division, products rounded before
// they are summed (__fmul_rn keeps nvcc from contracting them into an
// FMA), as XLA evaluates the scan.  No --use_fast_math, so subnormals are
// kept: at c ~ 3.4e38 PA2's 0.5/c is a subnormal here and 0 under XLA on
// the CPU, which flushes them; any normal sqn absorbs either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Method { PA = 0, PA1 = 1, PA2 = 2 };

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m > 0; m >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, m));
  return x;
}

// jnp.sign: -1, +1, and the argument itself for a signed zero or NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__global__ void __launch_bounds__(32, 1)
regression_scan_kernel(float* w, const int32_t* __restrict__ idx,
                       const float* __restrict__ val,
                       const float* __restrict__ tgt,
                       const float* __restrict__ mask, int B, int K,
                       int method, float c, float eps) {
  __shared__ float delta[32];
  const int lane = threadIdx.x;
  const bool has_first = lane < K;

  int n_col = 0;
  float n_val = 0.f, n_tgt = 0.f, n_mask = 0.f;
  if (B > 0) {
    if (has_first) {
      n_col = idx[lane];
      n_val = val[lane];
    }
    n_tgt = tgt[0];
    n_mask = mask[0];
  }

  for (int i = 0; i < B; ++i) {
    const long long row = (long long)i * K;
    const int col0 = n_col;
    const float v0 = n_val, y = n_tgt, mk = n_mask;
    if (i + 1 < B) {
      if (has_first) {
        n_col = idx[row + K + lane];
        n_val = val[row + K + lane];
      }
      n_tgt = tgt[i + 1];
      n_mask = mask[i + 1];
    }

    // 1. gather
    float g0 = 0.f, pred = 0.f, sqn = 0.f;
    if (has_first) {
      g0 = w[col0];
      pred = __fmul_rn(g0, v0);
      sqn = __fmul_rn(v0, v0);
    }
    for (int k = lane + 32; k < K; k += 32) {
      const float v = val[row + k];
      pred = __fadd_rn(pred, __fmul_rn(w[idx[row + k]], v));
      sqn = __fadd_rn(sqn, __fmul_rn(v, v));
    }
    pred = warp_sum(pred);
    sqn = warp_sum(sqn);

    // 2. step size
    const float err = __fsub_rn(y, pred);
    const float loss = __fsub_rn(fabsf(err), eps);
    float tau;
    if (method == PA) {
      tau = __fdiv_rn(loss, sqn);
    } else if (method == PA1) {
      const float q = __fdiv_rn(loss, sqn);
      tau = q > c ? c : q;              // jnp.minimum: a NaN q stays NaN
    } else {
      tau = __fdiv_rn(loss, __fadd_rn(sqn, __fdiv_rn(0.5f, c)));
    }
    if (!(mk > 0.f && loss > 0.f && sqn > 0.f)) tau = 0.f;
    const float coef = __fmul_rn(sign_of(err), tau);

    // 3. scatter, chunk by chunk
    for (int base = 0; base < K; base += 32) {
      const int k = base + lane;
      const bool live = k < K;
      int col;
      float v;
      if (base == 0) {
        col = col0;
        v = v0;
      } else {
        col = live ? idx[row + k] : 0;
        v = live ? val[row + k] : 0.f;
      }
      delta[lane] = __fmul_rn(coef, v);
      const unsigned grp = __match_any_sync(FULL, live ? col : -1 - lane);
      __syncwarp();
      if (live && __ffs(grp) - 1 == lane) {
        // chunk 0's gather is still current: nothing of this datum has
        // been stored yet
        float acc = base == 0 ? g0 : w[col];
        for (unsigned m = grp; m; m &= m - 1)
          acc = __fadd_rn(acc, delta[__ffs(m) - 1]);
        w[col] = acc;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C entry point: every pointer and the stream as void*; method 0-2
// (PA, PA1, PA2).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int regression_scan_launch(void* w, const void* indices,
                                      const void* values, const void* targets,
                                      const void* mask, int B, int K,
                                      int method, float c, float eps,
                                      void* stream) {
  if (B < 0 || K < 1 || method < PA || method > PA2)
    return (int)cudaErrorInvalidValue;
  regression_scan_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (float*)w, (const int32_t*)indices, (const float*)values,
      (const float*)targets, (const float*)mask, B, K, method, c, eps);
  return (int)cudaGetLastError();
}
