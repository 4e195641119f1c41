// The sublinear query index's probe-and-rescore kernels for Hopper
// (sm_90a).  They replace XLA code of jubatus_tpu/ops/candidates.py (the
// repo's Pallas kernels are the quantizer pair, csrc/quantize.cu):
//   K6 sig_probe  <- _sig_probe_from_datum / _from_row / _batch (:227-265),
//                    through probe_groups_traced (:87), _gather_candidates
//                    (:163) and _rescore_sig (:188)
//   K7 ivf_probe  <- _ivf_probe_query (:367)
//
// One block a query, one launch a call; K7 takes one query, its centroid
// stage needs no grid-wide step (C centroids of E coordinates fit one
// block), so it is one launch too.
//
// Both follow jax.lax.top_k over the CANDIDATE vector: the P probed groups'
// `cap` slots each (flat[offset:offset + cap], the start clamped as
// dynamic_slice clamps it, -1 past the group's length), then the delta's
// Dcap rows; a row can appear more than once.  Candidate i's key is K3's
// (csrc/lsh.cu make_key): the score's bits with the low 31 flipped where
// negative in the high word, 0xFFFFFFFF - i in the low word, so the keys
// order as lax.top_k orders the vector, ties to the lower POSITION.  A
// candidate that names no row (-1), a row at or past the valid count, or
// one the optional mask leaves out scores -inf.  The result a query is
// [2 kb + 1] int64: the top kb keys, descending; the row each key's
// position names (-1 for an empty slot); the count of valid candidates
// (duplicates counted, as jnp.sum(ok)).
//
// K6's score is the full sweep's (K3): lsh 1 - popc/H and minhash equal/H
// from K3's count table, euclid_lsh -sqrt(max(fma(-2 qn n, cos, fma(n, n,
// qn qn)), 0)) with K3's cosine table, no flush (the JAX program's bits,
// held by tests/test_torch_candidates.py).  The query is a signature with
// its norm, or a stored row whose signature and norm the kernel reads.
//
// K7, in XLA's CPU order of _ivf_probe_query (read off its dump):
//   * the query's count-sketch embedding e [E]: coordinate (i * 0x9E3779B1)
//     >> (32 - log2 E), sign bit (i * 0x85EBCA77) >> 31; the signed values
//     added one at a time in k order into their coordinates from +0 (XLA's
//     scatter loop);
//   * centroid c's score dot - 0.5 ssq: the dot is XLA's row-major gemv,
//     8 lanes a row (lane j a chain of fused multiply-adds over k = j mod
//     8), then ((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7)), or for
//     the rows past the last whole tile of 8 ((l0 + l4) + (l2 + l6)) +
//     ((l1 + l5) + (l3 + l7)), then + 0; ssq as XLA's reduce orders it at
//     E (8: rounded products in k order; 16, 32: fused chain; 64 to 1024:
//     windows of 32 rounded products, each summed in k order from +0, then
//     the window sums in order from +0);
//   * the top `probes` centroids by the same keys (ties: lower index);
//     groups c and c + C for each (the rank-2 assignment's two bands, all
//     first bands first);
//   * a candidate row's dot in the order of jnp.einsum("ck,ck->c"): the
//     first product, the next seven rounded and added, the rest fused (K4
//     dense_topk's F_EINSUM); cosine dot / max(n qn, 1e-12), euclid
//     -sqrt(max(fma(n, n, qn qn) - 2 dot, 0)).
// Every K7 input and step is flushed (DAZ/FTZ, XLA's CPU mode): .ftz
// instructions.  No --use_fast_math.
//
// Selection: the keys of a query (K7: first the centroids', then the
// candidates') go to a buffer of npad = pow2(width) entries, the tail
// padded with KEY_MIN, in shared memory up to PROBE_SMEM_KEYS bytes and
// otherwise in the caller's workspace in device memory.  A bitonic top-k
// keeps the largest kb at any kb up to the width: runs of R = pow2(kb)
// keys are sorted in alternating directions (the bitonic network up to
// size R), then pairs of runs are folded by an elementwise max (the top R
// of the pair, a bitonic sequence) and merged back to sorted, halving the
// runs until one remains: O(n log^2 R) compare-exchanges, a block barrier
// a step.
// Bound, as built: a block's chain of dependent steps, not the bytes: the
// candidates' scattered row reads (one a thread in flight) and the sort's
// barriers; one SM a query.  A simple kernel that is right; its redesign
// (several blocks a query, a counting select) is later work (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PROBE_THREADS = 512;
// keys a query held in shared memory (bytes); a wider buffer lives in the
// workspace (ops/candidates.py PROBE_SMEM_KEYS mirrors it)
constexpr long long PROBE_SMEM_KEYS = 128 * 1024;
constexpr long long KEY_MIN = (long long)0x8000000000000000ULL;
constexpr uint32_t CS_H = 0x9E3779B1u;
constexpr uint32_t CS_S = 0x85EBCA77u;

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float div_ftz(float x, float y) {
  float d;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(x), "f"(y));
  return d;
}
__device__ __forceinline__ float sqrt_ftz(float x) {
  float d;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(d) : "f"(x));
  return d;
}

// K3's key (csrc/lsh.cu make_key): position r in the low word
__device__ __forceinline__ long long make_key(float s, uint32_t r) {
  int bits = __float_as_int(s);
  if (bits < 0) bits ^= 0x7FFFFFFF;
  return (long long)(((unsigned long long)(uint32_t)bits << 32) |
                     (unsigned long long)(0xFFFFFFFFu - r));
}

__device__ __forceinline__ uint32_t key_pos(long long key) {
  return 0xFFFFFFFFu - (uint32_t)(unsigned long long)key;
}

__device__ __forceinline__ void cmp_swap(long long* k, int i, int l,
                                         bool desc) {
  const long long a = k[i], b = k[l];
  if (desc ? a < b : a > b) {
    k[i] = b;
    k[l] = a;
  }
}

// the largest kb keys of k[0, n) (n a power of two) to k[0, kb), in
// descending order; every thread of the block calls it
__device__ void block_topk(long long* k, int n, int kb) {
  int run = 1;
  while (run < kb) run <<= 1;
  const int half = n >> 1;
  // runs of `run` keys sorted, run q descending for even q
  for (int s = 2; s <= run; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        cmp_swap(k, i, i + j, (i & s) == 0);
      }
      __syncthreads();
    }
  }
  // fold pairs of runs: the survivors sit at multiples of 2 * stride
  for (int stride = run; stride < n; stride <<= 1) {
    const int pairs = n / (2 * stride);
    for (int t = threadIdx.x; t < pairs * run; t += blockDim.x) {
      const int p = t / run, o = t % run;
      long long* a = k + 2 * (long long)p * stride;
      const long long b = a[stride + o];
      if (b > a[o]) a[o] = b;
    }
    __syncthreads();
    for (int j = run >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pairs * (run >> 1); t += blockDim.x) {
        const int p = t / (run >> 1), u = t % (run >> 1);
        const int i = 2 * j * (u / j) + (u % j);
        cmp_swap(k + 2 * (long long)p * stride, i, i + j, (p & 1) == 0);
      }
      __syncthreads();
    }
  }
}

// the probed groups' slots of the candidate vector: group p's start
// (clamped) and length, then the delta
struct Groups {
  long long* start;
  int* len;
};

__device__ __forceinline__ long long candidate(
    long long i, const Groups& g, int P, int cap, const int* __restrict__ flat,
    const int* __restrict__ delta) {
  const long long pc = (long long)P * cap;
  if (i < pc) {
    const int p = (int)(i / cap), o = (int)(i % cap);
    return o < g.len[p] ? (long long)__ldg(flat + g.start[p] + o) : -1;
  }
  return (long long)__ldg(delta + (i - pc));
}

__device__ __forceinline__ void group_at(const Groups& g, int p, long long gid,
                                         long long flat_len, int cap,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ lens) {
  long long s = __ldg(offsets + gid);
  const long long hi = flat_len - cap;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  g.start[p] = s;
  g.len[p] = __ldg(lens + gid);
}

__device__ __forceinline__ bool valid_row(long long c, long long n_valid,
                                          const unsigned char* mask) {
  return c >= 0 && c < n_valid && (mask == nullptr || __ldg(mask + c) != 0);
}

// the query's block-wide candidate count and the result row
__device__ void write_result(const long long* keys, int kb, const Groups& g,
                             int P, int cap, const int* flat,
                             const int* delta, const int* cnt,
                             long long* out) {
  for (int j = threadIdx.x; j < kb; j += blockDim.x) {
    const long long key = keys[j];
    out[j] = key;
    out[kb + j] = candidate(key_pos(key), g, P, cap, flat, delta);
  }
  if (threadIdx.x == 0) out[2 * kb] = *cnt;
}

__device__ __forceinline__ long long* key_buffer(unsigned char* smem,
                                                 size_t head,
                                                 long long* ws, int npad) {
  return ws != nullptr ? ws + (long long)blockIdx.x * npad
                       : reinterpret_cast<long long*>(smem + head);
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

template <int KIND>
__global__ void __launch_bounds__(PROBE_THREADS)
sig_probe_kernel(const uint32_t* __restrict__ table,
                 const float* __restrict__ norms, long long R, int W,
                 long long n_valid, const unsigned char* __restrict__ mask,
                 const uint32_t* __restrict__ q_sigs,
                 const float* __restrict__ q_norms,
                 const long long* __restrict__ q_rows,
                 const int* __restrict__ flat, long long flat_len,
                 const int* __restrict__ offsets,
                 const int* __restrict__ lens, const int* __restrict__ delta,
                 int dcap, const int* __restrict__ plan, int P, int bits,
                 int cap, const float* __restrict__ tab, int kb, int npad,
                 long long* ws, long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);
  const size_t qbytes = ((size_t)W * 4 + 15) / 16 * 16;
  Groups g;
  g.start = reinterpret_cast<long long*>(smem + qbytes);
  g.len = reinterpret_cast<int*>(smem + qbytes + (size_t)P * 8);
  int* cnt = g.len + P;
  float* qn_s = reinterpret_cast<float*>(cnt + 1);
  const size_t head = (qbytes + (size_t)P * 12 + 8 + 15) / 16 * 16;
  long long* keys = key_buffer(smem, head, ws, npad);
  const int q = blockIdx.x;
  const uint32_t* src = q_rows != nullptr ? table + q_rows[q] * W
                                          : q_sigs + (long long)q * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) qs[w] = src[w];
  if (threadIdx.x == 0) {
    *cnt = 0;
    *qn_s = q_rows != nullptr ? norms[q_rows[q]] : q_norms[q];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int band = plan[2 * p], xmask = plan[2 * p + 1];
    uint32_t v = 0;
    if (KIND == 1) {
      v = qs[band] & ((1u << bits) - 1u);
    } else {
      for (int j = 0; j < bits; ++j) {
        const int pos = band * bits + j;
        v |= ((qs[pos >> 5] >> (pos & 31)) & 1u) << j;
      }
    }
    const long long gid = (long long)band * (1LL << bits) + (v ^ xmask);
    group_at(g, p, gid, flat_len, cap, offsets, lens);
  }
  __syncthreads();
  const long long width = (long long)P * cap + dcap;
  const float qn = *qn_s;
  int mine = 0;
  for (int i = threadIdx.x; i < npad; i += blockDim.x) {
    long long key = KEY_MIN;
    if (i < width) {
      const long long c = candidate(i, g, P, cap, flat, delta);
      float s = -INFINITY;
      if (valid_row(c, n_valid, mask)) {
        ++mine;
        const uint32_t* row = table + c * W;
        int n = 0;
        for (int w = 0; w < W; ++w) {
          const uint32_t x = __ldg(row + w);
          n += KIND == 1 ? (int)(x == qs[w]) : __popc(x ^ qs[w]);
        }
        s = __ldg(tab + n);
        if (KIND == 2) {
          const float nr = __ldg(norms + c);
          const float a = __fmaf_rn(nr, nr, __fmul_rn(qn, qn));
          const float d2 =
              __fmaf_rn(-__fmul_rn(__fmul_rn(2.0f, qn), nr), s, a);
          s = -__fsqrt_rn(fmaxf(d2, 0.0f));
        }
      }
      key = make_key(s, (uint32_t)i);
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(cnt, mine);
  __syncthreads();
  block_topk(keys, npad, kb);
  write_result(keys, kb, g, P, cap, flat, delta, cnt,
               out + (long long)q * (2 * kb + 1));
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// a sparse row's dot with the dense query in jnp.einsum's order
__device__ __forceinline__ float einsum_dot(const int* __restrict__ ri,
                                            const float* __restrict__ rv,
                                            int Kr,
                                            const float* __restrict__ qd) {
  float acc = mul_ftz(__ldg(qd + __ldg(ri)), __ldg(rv));
  for (int k = 1; k < Kr; ++k) {
    const float g = __ldg(qd + __ldg(ri + k)), v = __ldg(rv + k);
    acc = k < 8 ? add_ftz(acc, mul_ftz(g, v)) : fma_ftz(g, v, acc);
  }
  return acc;
}

// sum(c * c) of a centroid row in XLA's reduce order at E
__device__ __forceinline__ float centroid_ssq(const float* __restrict__ c,
                                              int E) {
  if (E < 64) {
    float acc = 0.0f;
    for (int k = 0; k < E; ++k) {
      const float x = __ldg(c + k);
      acc = E > 8 ? fma_ftz(x, x, acc) : add_ftz(acc, mul_ftz(x, x));
    }
    return acc;
  }
  float tot = 0.0f;
  for (int w0 = 0; w0 < E; w0 += 32) {
    float win = 0.0f;
    for (int k = w0; k < w0 + 32; ++k) {
      const float x = __ldg(c + k);
      win = add_ftz(win, mul_ftz(x, x));
    }
    tot = add_ftz(tot, win);
  }
  return tot;
}

template <int METRIC>
__global__ void __launch_bounds__(PROBE_THREADS)
ivf_probe_kernel(const int* __restrict__ q_idx,
                 const float* __restrict__ q_val, int K,
                 const float* __restrict__ q_dense, float qnorm,
                 const float* __restrict__ cent, int C, int E, int log2e,
                 int probes, const int* __restrict__ r_idx,
                 const float* __restrict__ r_val,
                 const float* __restrict__ norms, int Kr, long long n_valid,
                 const unsigned char* __restrict__ mask,
                 const int* __restrict__ flat, long long flat_len,
                 const int* __restrict__ offsets,
                 const int* __restrict__ lens, const int* __restrict__ delta,
                 int dcap, int cap, int kb, int npad, int cpad,
                 long long* ws, long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  const size_t ebytes = ((size_t)E * 4 + 15) / 16 * 16;
  const int P = 2 * probes;
  Groups g;
  g.start = reinterpret_cast<long long*>(smem + ebytes);
  g.len = reinterpret_cast<int*>(smem + ebytes + (size_t)P * 8);
  int* cnt = g.len + P;
  const size_t head = (ebytes + (size_t)P * 12 + 4 + 15) / 16 * 16;
  const int n = npad > cpad ? npad : cpad;
  long long* keys = key_buffer(smem, head, ws, n);
  for (int j = threadIdx.x; j < E; j += blockDim.x) e[j] = 0.0f;
  __syncthreads();
  if (threadIdx.x == 0) {
    *cnt = 0;
    for (int k = 0; k < K; ++k) {
      const uint32_t i = (uint32_t)q_idx[k];
      const uint32_t h = (i * CS_H) >> (32 - log2e);
      const float v = q_val[k];
      const float u = (i * CS_S) >> 31 ? -v : v;
      e[h] = add_ftz(e[h], u);
    }
  }
  __syncthreads();
  const int whole = 8 * (C / 8);
  for (int c = threadIdx.x; c < cpad; c += blockDim.x) {
    long long key = KEY_MIN;
    if (c < C) {
      const float* row = cent + (long long)c * E;
      float l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) l[j] = 0.0f;
      for (int k = 0; k < E; k += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          l[j] = fma_ftz(__ldg(row + k + j), e[k + j], l[j]);
      }
      float dot;
      if (c < whole) {
        dot = add_ftz(add_ftz(add_ftz(l[0], l[1]), add_ftz(l[2], l[3])),
                      add_ftz(add_ftz(l[4], l[5]), add_ftz(l[6], l[7])));
      } else {
        dot = add_ftz(add_ftz(add_ftz(l[0], l[4]), add_ftz(l[2], l[6])),
                      add_ftz(add_ftz(l[1], l[5]), add_ftz(l[3], l[7])));
      }
      dot = add_ftz(dot, 0.0f);
      const float s = sub_ftz(dot, mul_ftz(0.5f, centroid_ssq(row, E)));
      key = make_key(s, (uint32_t)c);
    }
    keys[c] = key;
  }
  __syncthreads();
  block_topk(keys, cpad, probes);
  for (int p = threadIdx.x; p < probes; p += blockDim.x) {
    const long long c = key_pos(keys[p]);
    group_at(g, p, c, flat_len, cap, offsets, lens);
    group_at(g, probes + p, c + C, flat_len, cap, offsets, lens);
  }
  __syncthreads();
  const long long width = (long long)P * cap + dcap;
  const float qn = qnorm;
  int mine = 0;
  for (int i = threadIdx.x; i < npad; i += blockDim.x) {
    long long key = KEY_MIN;
    if (i < width) {
      const long long c = candidate(i, g, P, cap, flat, delta);
      float s = -INFINITY;
      if (valid_row(c, n_valid, mask)) {
        ++mine;
        const float dot = einsum_dot(r_idx + c * Kr, r_val + c * Kr, Kr,
                                     q_dense);
        const float nr = __ldg(norms + c);
        if (METRIC == 0) {
          s = div_ftz(dot, fmaxf(mul_ftz(nr, qn), 1e-12f));
        } else {
          const float a = fma_ftz(nr, nr, mul_ftz(qn, qn));
          s = -sqrt_ftz(fmaxf(add_ftz(a, -2.0f * dot), 0.0f));
        }
      }
      key = make_key(s, (uint32_t)i);
    }
    keys[i] = key;
  }
  if (mine) atomicAdd(cnt, mine);
  __syncthreads();
  block_topk(keys, npad, kb);
  write_result(keys, kb, g, P, cap, flat, delta, cnt, out);
}

// a kernel's dynamic shared memory above the default 48 KB
template <typename F>
int allow_smem(F kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool pow2(long long n) { return n > 0 && (n & (n - 1)) == 0; }

}  // namespace

// K6: Nq queries (q_sigs [Nq, W] with q_norms [Nq], or q_rows [Nq]);
// ws: null, or Nq * npad int64 when npad * 8 > PROBE_SMEM_KEYS
extern "C" int sig_probe_launch(
    const void* table, const void* norms, long long R, int W,
    long long n_valid, const void* mask, const void* q_sigs,
    const void* q_norms, const void* q_rows, int NQ, const void* flat,
    long long flat_len, const void* offsets, const void* lens,
    const void* delta, int dcap, const void* plan, int P, int bits, int cap,
    int kind, const void* tab, int kb, int npad, void* ws, void* out,
    void* stream) {
  const long long width = (long long)P * cap + dcap;
  if (NQ <= 0 || W <= 0 || P <= 0 || cap <= 0 || kind < 0 || kind > 2 ||
      kb < 1 || kb > width || !pow2(npad) || npad < width ||
      flat_len < cap || n_valid > R || width > 0x7FFFFFFFLL ||
      (ws == nullptr && npad * 8LL > PROBE_SMEM_KEYS))
    return (int)cudaErrorInvalidValue;
  const size_t head = (((size_t)W * 4 + 15) / 16 * 16 + (size_t)P * 12 + 8 +
                       15) / 16 * 16;
  const size_t smem = head + (ws == nullptr ? (size_t)npad * 8 : 0);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SIG_PROBE_ARGS                                                      \
  (const uint32_t*)table, (const float*)norms, R, W, n_valid,               \
      (const unsigned char*)mask, (const uint32_t*)q_sigs,                  \
      (const float*)q_norms, (const long long*)q_rows, (const int*)flat,    \
      flat_len, (const int*)offsets, (const int*)lens, (const int*)delta,   \
      dcap, (const int*)plan, P, bits, cap, (const float*)tab, kb, npad,    \
      (long long*)ws, (long long*)out
  int err;
  switch (kind) {
    case 0:
      err = allow_smem(sig_probe_kernel<0>, smem);
      if (err) return err;
      sig_probe_kernel<0><<<NQ, PROBE_THREADS, smem, s>>>(SIG_PROBE_ARGS);
      break;
    case 1:
      err = allow_smem(sig_probe_kernel<1>, smem);
      if (err) return err;
      sig_probe_kernel<1><<<NQ, PROBE_THREADS, smem, s>>>(SIG_PROBE_ARGS);
      break;
    default:
      err = allow_smem(sig_probe_kernel<2>, smem);
      if (err) return err;
      sig_probe_kernel<2><<<NQ, PROBE_THREADS, smem, s>>>(SIG_PROBE_ARGS);
  }
#undef SIG_PROBE_ARGS
  return (int)cudaGetLastError();
}

// K7: one query; ws: null, or max(npad, cpad) int64 when that many keys
// pass PROBE_SMEM_KEYS
extern "C" int ivf_probe_launch(
    const void* q_idx, const void* q_val, int K, const void* q_dense,
    float qnorm, const void* cent, int C, int E, int probes,
    const void* r_idx, const void* r_val, const void* norms, long long R,
    int Kr, long long n_valid, const void* mask, const void* flat,
    long long flat_len, const void* offsets, const void* lens,
    const void* delta, int dcap, int cap, int metric, int kb, int npad,
    int cpad, void* ws, void* out, void* stream) {
  const long long width = 2LL * probes * cap + dcap;
  int log2e = 0;
  while ((1 << log2e) < E) ++log2e;
  const int n = npad > cpad ? npad : cpad;
  if (K <= 0 || C <= 0 || !pow2(E) || E < 8 || E > 1024 || probes < 1 ||
      probes > C || Kr <= 0 || cap <= 0 || metric < 0 || metric > 1 ||
      kb < 1 || kb > width || !pow2(npad) || npad < width || !pow2(cpad) ||
      cpad < C || flat_len < cap || n_valid > R || width > 0x7FFFFFFFLL ||
      (ws == nullptr && n * 8LL > PROBE_SMEM_KEYS))
    return (int)cudaErrorInvalidValue;
  const size_t head = (((size_t)E * 4 + 15) / 16 * 16 +
                       (size_t)2 * probes * 12 + 4 + 15) / 16 * 16;
  const size_t smem = head + (ws == nullptr ? (size_t)n * 8 : 0);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define IVF_PROBE_ARGS                                                      \
  (const int*)q_idx, (const float*)q_val, K, (const float*)q_dense, qnorm,  \
      (const float*)cent, C, E, log2e, probes, (const int*)r_idx,           \
      (const float*)r_val, (const float*)norms, Kr, n_valid,                \
      (const unsigned char*)mask, (const int*)flat, flat_len,               \
      (const int*)offsets, (const int*)lens, (const int*)delta, dcap, cap,  \
      kb, npad, cpad, (long long*)ws, (long long*)out
  int err;
  if (metric == 0) {
    err = allow_smem(ivf_probe_kernel<0>, smem);
    if (err) return err;
    ivf_probe_kernel<0><<<1, PROBE_THREADS, smem, s>>>(IVF_PROBE_ARGS);
  } else {
    err = allow_smem(ivf_probe_kernel<1>, smem);
    if (err) return err;
    ivf_probe_kernel<1><<<1, PROBE_THREADS, smem, s>>>(IVF_PROBE_ARGS);
  }
#undef IVF_PROBE_ARGS
  return (int)cudaGetLastError();
}
