// The sublinear query index's probe-and-rescore kernels for Hopper
// (sm_90a).  They replace XLA code of jubatus_tpu/ops/candidates.py (the
// repo's Pallas kernels are the quantizer pair, csrc/quantize.cu):
//   K6 sig_probe  <- _sig_probe_from_datum / _from_row / _batch (:227-265),
//                    through probe_groups_traced (:87), _gather_candidates
//                    (:163) and _rescore_sig (:188)
//   K7 ivf_probe  <- _ivf_probe_query (:367)
//
// Both follow jax.lax.top_k over the CANDIDATE vector: the P probed groups'
// `cap` slots each (flat[offset:offset + cap], the start clamped as
// dynamic_slice clamps it, -1 past the group's length), then the delta's
// Dcap rows; a row can appear more than once.  Candidate i's key is K3's
// (csrc/lsh.cu make_key): the score's bits with the low 31 flipped where
// negative in the high word, 0xFFFFFFFF - i in the low word, so the keys
// order as lax.top_k orders the vector, ties to the lower POSITION, and no
// two keys are equal.  A candidate that names no row (-1), a row at or
// past the valid count, or one the optional mask leaves out scores -inf.
// The result a query is [2 kb + 1] int64: the top kb keys, descending;
// the row each key's position names (-1 for an empty slot); the count of
// valid candidates (duplicates counted, as jnp.sum(ok)).
//
// K6's score is the full sweep's (K3): lsh 1 - popc/H and minhash equal/H
// from K3's count table, euclid_lsh -sqrt(max(fma(-2 qn n, cos, fma(n, n,
// qn qn)), 0)) with K3's cosine table, no flush (the JAX program's bits,
// held by tests/test_torch_candidates.py).  The query is a signature with
// its norm, or a stored row whose signature and norm the kernel reads.
//
// K7, in XLA's CPU order of _ivf_probe_query (read off its dumps,
// XLA_FLAGS=--xla_dump_to, the *ir-with-opt.ll and objdump -d of the
// object files, at E 1 to 16,384 and 2^17 to 2^20; the same orders hold
// bitwise at 32,768 and 65,536 in tests/test_torch_candidates.py):
//   * the query's count-sketch embedding e [E]: coordinate (i * 0x9E3779B1)
//     >> (32 - log2 E) (0 at E 1, where the shift is 32), sign bit
//     (i * 0x85EBCA77) >> 31; the signed values added one at a time in k
//     order into their coordinates from +0 (XLA's scatter loop, at every
//     E);
//   * centroid c's score dot - 0.5 ssq.  The dot is XLA's row-major gemv
//     (row_major_gemv_F32_8_8_C_E: tiles of 8 rows, 8-wide vectors; at E
//     16,384 and up the rows are split between two tasks, which leaves a
//     row's sum as it is).  E 8 and up: 8 lanes a row (lane j a chain of
//     fused multiply-adds over k = j mod 8), then ((l0 + l1) + (l2 + l3))
//     + ((l4 + l5) + (l6 + l7)), or for the rows past the last whole tile
//     of 8 ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7)), then + 0.
//     E 2 and 4: no whole vector of columns, so every row is the gemv's
//     epilogue loop alone, one chain of fused multiply-adds in k order
//     from +0, then + 0.  ssq as XLA's reduce orders it at E: 8, rounded
//     products added in k order from +0 on the rows LLVM's vectorized
//     loop takes (ssq_vector_rows), a chain of fused multiply-adds from +0
//     on its scalar loop's; 2, 4, 16 and 32, a chain of fused
//     multiply-adds from +0; 64 and up, reduce-windows of 32 (each
//     window's rounded products summed in k order from +0), windowed
//     again by 32 while more than 32 sums are left (one level at 2,048 to
//     32,768, two at 65,536 to 2^20, three from 2^21), and the last sums
//     added in order from +0.  E 1: XLA folds the dot into the fusion,
//     one fused multiply-add fma(c, e, -(0.5 c c));
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
// Design (several blocks a query, a select in place of a sort):
//   stage 1, a grid of (candidate chunks of CHUNK positions) x (queries):
//     a block recomputes its query's P group starts and lengths (K6; K7
//     reads them from the workspace), reads `flat` and `delta` for its
//     positions (neighbouring threads on neighbouring positions), rescores
//     its valid candidates (J6 or J7 positions a thread, their row reads
//     issued together; K6 reads a row's words in pairs where it can),
//     keeps the chunk's keys in shared memory, selects the chunk's top
//     min(kb, CHUNK) and writes them in position order, with the chunk's
//     valid count and its keys at ranks kb/4, kb/2, 3 kb/4 and kb, to the
//     workspace;
//   stage 2, a block a query: drops the chunks' keys below a bound that
//     the chunks' quantile keys prove (kb keys at or above it);
//     up to RANK_DIRECT keys left, each key's rank among them places it
//     (one pass, no select), up to RANK_KEYS a bitonic sort of them; more,
//     the select below over all the chunks' lists (in position order
//     too), then a sort of the kb; writes the result.
//   The select (select_hi, gather_ordered): a radix select over the keys'
//   high words, the scores, 8 bits a pass from the top: a pass histograms
//   the keys that share the prefix found so far (shared-memory adds; a
//   warp whose keys all share a digit adds once; three histograms in turn,
//   so a pass needs one barrier) and every warp reads off it the digit
//   that holds the kb-th key; the passes stop once that digit's bucket
//   holds exactly the keys still wanted.  If they end on a whole score
//   with more keys than wanted, those keys tie on the score and their
//   order is the position's: the first ones in position order are taken
//   (one block scan), and no pass runs over the low words.  Each thread
//   holds a contiguous run of the keys, so the gather keeps position
//   order.  Chosen over K3's per-warp lists (csrc/lsh.cu
//   offer/flush_small): a list's entry costs kb/32 shifts a lane above kb
//   256, and K7 takes kb up to the width; the select costs at most 4
//   passes over the keys at any kb, and padding or -inf keys never enter a
//   sort.  The kb survivors are placed by rank (each counts the keys above
//   it) up to RANK_SORT_MAX, else by a bitonic sort of pow2(kb).  A list
//   of the chunks' keys past S2_SMEM_KEYS is selected from device memory,
//   and kb past SORT_SMEM_KEYS is sorted there (slow, legal at any kb).
//   A pass is a chain of shared-memory adds to few words, shuffles and a
//   barrier: the rank path of stage 2 spares the most of them.
//   K7 runs before that a centroid stage: a block of CPB centroids builds
//   the embedding in shared memory (up to EMB_SMEM bytes; wider, one block
//   builds it into the workspace first) with one warp, 32 features a step
//   (features of a step that share a coordinate are added in k order by
//   the lowest lane); 8 lanes score a centroid (the gemv's 8 chains, row
//   reads coalesced), the 8 lanes share its ssq by windows (up to E 1,024)
//   or by runs of 32 windows (above), and lane 0 adds them in XLA's
//   order; then one block takes the top `probes` centroid keys one at a
//   time (up to PICK_EXTRACT; above, the select) and writes the 2 probes
//   groups.  A call is 4 launches (5 with the embedding in device
//   memory), K6's 2, all on the caller's stream.
// Bound: the candidates' scattered row reads, the select's barriers and
// the launches' gaps, not the bytes (PERF.md section 6); stage 1 spreads a
// read over ceil(width / CHUNK) SMs.
// Variants for scripts/torch_probe_split.py's split of a call: built with
// -DPROBE_UPTO=n a call stops after its stage n (K7: 1 the embedding and
// the centroids, 2 the pick, 3 stage 1, 4 stage 2; K6: 3, 4); with
// -DPROBE_NO_SELECT stage 1 writes its chunk's first keys unselected.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PROBE_UPTO
#define PROBE_UPTO 4
#endif

namespace {

constexpr int CHUNK = 1024;              // candidate positions a stage-1 block
// stage-1 threads: K6 4 positions a thread (a batch of queries runs more
// blocks than SMs), K7 2 (its dots are longer chains of loads)
constexpr int T6 = 256;
constexpr int T7 = 512;
constexpr int J6 = CHUNK / T6;
constexpr int J7 = CHUNK / T7;
constexpr int TP = 256;                  // the embedding's and the pick's
constexpr int T2 = 512;                  // stage-2 threads, a block a query
constexpr int TC = 256;                  // centroid-stage threads
constexpr int CPB = TC / 8;              // centroids a centroid-stage block
// the chunks' lists held in shared memory by stage 2 up to this many keys
constexpr long long S2_SMEM_KEYS = 12288;
// stage 2 places the keys at or above its bound by rank (each counts the
// keys above it) up to RANK_DIRECT of them, by a bitonic sort up to
// RANK_KEYS; above, the radix select over all the chunks' lists
constexpr int RANK_DIRECT = 256;
constexpr int RANK_KEYS = 1024;
// a chunk's keys at NQ ranks of its top kb (rank ceil(kb (q + 1) / NQ))
// bound stage 2, where kb <= QUANT_KB (above, its kb-th key alone)
constexpr int NQ = 4;
constexpr int QUANT_KB = 256;
// the final kb keys sorted in shared memory up to pow2(kb) this many
constexpr long long SORT_SMEM_KEYS = 4096;
// the centroid keys held in shared memory by the pick up to this many
constexpr long long PICK_SMEM_KEYS = 8192;
// the pick's sort of pow2(probes) keys is in shared memory: probes cap
constexpr int MAX_PROBES = 8192;
// the pick takes the keys one at a time up to this many probes
constexpr int PICK_EXTRACT = 16;
// the embedding in shared memory up to E * 4 bytes
constexpr long long EMB_SMEM = 64 * 1024;
// the widest embedding: a centroid's coordinates are 32-bit ints
constexpr int MAX_E = 1 << 30;
constexpr long long KEY_MIN = (long long)0x8000000000000000ULL;
constexpr unsigned FULL = 0xFFFFFFFFu;
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

// a key as an unsigned number of the same order (KEY_MIN -> 0)
__device__ __forceinline__ unsigned long long ukey(long long key) {
  return (unsigned long long)key ^ 0x8000000000000000ULL;
}

// ---------------------------------------------------------------------------
// the workspace: a region a query (its groups, its chunks' counts, kb-th
// keys and lists, the sort buffer of a kb too large for shared memory),
// then K7's centroid keys and, where it passes EMB_SMEM, the embedding
// ---------------------------------------------------------------------------

struct Layout {
  long long groups, cnt, kth, keys, sort, per_q;  // byte offsets, a region
  int nchunks, kbc, R;
};

// the rank (from 1) of a chunk's quantile q
__host__ __device__ inline int quant_rank(int kb, int q) {
  return (kb * (q + 1) + NQ - 1) / NQ;
}

__host__ __device__ inline long long up16(long long b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline Layout layout(long long width, int P, int kb) {
  Layout L;
  L.nchunks = (int)((width + CHUNK - 1) / CHUNK);
  L.kbc = kb < CHUNK ? kb : CHUNK;
  int R = 1;
  while (R < kb) R <<= 1;
  L.R = R;
  L.groups = 0;
  L.cnt = up16(16LL * P);
  L.kth = L.cnt + up16(4LL * L.nchunks);
  L.keys = L.kth + up16(8LL * NQ * L.nchunks);
  L.sort = L.keys + 8LL * L.nchunks * L.kbc;
  L.per_q = up16(L.sort + (R > SORT_SMEM_KEYS ? 8LL * R : 0));
  return L;
}

// ---------------------------------------------------------------------------
// block-wide select, gather and sort
// ---------------------------------------------------------------------------

// the select's shared memory: three histograms (a pass counts into one
// and clears the next, so one barrier a pass suffices) and a scan's warp
// sums
struct Sel {
  unsigned hist[3][256];
  long long wsum[32];
  unsigned long long kmin, kmax;  // a block's least / largest key (ukey)
  int kept;                       // stage 2's keys at or above its bound
};
constexpr int SEL_BYTES = ((int)sizeof(Sel) + 15) / 16 * 16;
// the final kb keys sorted by rank (each key counts the keys above it) up
// to this many, by a bitonic sort above
constexpr int RANK_SORT_MAX = 1024;

// where a select ended: the kb largest keys are those whose high word's
// bits above `shift` exceed `prefix`, then those equal to it: all of them
// if `done`, else (shift 0: the whole score) the first `rem` in array
// order
struct Pick {
  unsigned prefix;
  int shift;
  int rem;
  bool done;
};

// a thread's share of n keys: a contiguous run, so thread order is array
// order
__device__ __forceinline__ long long run_len(long long n) {
  return (n + blockDim.x - 1) / blockDim.x;
}

__device__ __forceinline__ unsigned key_hi(long long k) {
  return (unsigned)(ukey(k) >> 32);
}

// The kb largest of keys[0, n) (unique keys, 1 <= kb <= n; KEY_MIN
// fillers allowed below them), phase A: a radix select over the keys' high
// words (the scores), 8 bits a pass from the top.  A pass histograms the
// keys that share the prefix so far (shared-memory adds, one a warp where
// its lanes share the digit) and every warp reads the digit that
// holds the kb-th key off it (the same digit in each); the passes stop
// once that digit's bucket holds exactly the keys still wanted.  Every
// thread calls it.
__device__ Pick select_hi(const long long* keys, long long n, int kb,
                          Sel* st) {
  const int lane = threadIdx.x & 31;
  const long long per = run_len(n), lo = threadIdx.x * per;
  Pick pk{0u, 32, kb, false};
  for (int b = threadIdx.x; b < 256; b += blockDim.x) st->hist[0][b] = 0;
  __syncthreads();
  for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
    unsigned* cur = st->hist[pass % 3];
    unsigned* nxt = st->hist[(pass + 1) % 3];
    for (long long j = 0; j < per; ++j) {
      const long long i = lo + j;
      int d = -1;
      if (i < n) {
        const unsigned hi = key_hi(keys[i]);
        if (pk.shift == 32 || (hi >> pk.shift) == pk.prefix)
          d = (int)((hi >> shift) & 0xFF);
      }
      // one add where the warp's lanes share the digit
      const int d0 = __shfl_sync(FULL, d, 0);
      if (__all_sync(FULL, d == d0)) {
        if (lane == 0 && d0 >= 0) atomicAdd(cur + d0, 32u);
      } else if (d >= 0) {
        atomicAdd(cur + d, 1u);
      }
    }
    for (int b = threadIdx.x; b < 256; b += blockDim.x) nxt[b] = 0;
    __syncthreads();
    // lane l holds the digits 255 - 8 l down to 248 - 8 l (two 16-byte
    // loads)
    const unsigned rem = (unsigned)pk.rem;
    const uint4 lo4 = *reinterpret_cast<const uint4*>(cur + 248 - 8 * lane);
    const uint4 hi4 = *reinterpret_cast<const uint4*>(cur + 252 - 8 * lane);
    const unsigned hb[8] = {hi4.w, hi4.z, hi4.y, hi4.x,
                            lo4.w, lo4.z, lo4.y, lo4.x};
    unsigned sum = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) sum += hb[x];
    unsigned incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    unsigned acc = incl - sum;
    const bool mine = acc < rem && rem <= incl;
    int dig = 0;
    unsigned left = 0, h = 0;
    bool found = false;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      if (mine && !found) {
        if (acc + hb[x] >= rem) {
          found = true;
          dig = 255 - 8 * lane - x;
          h = hb[x];
          left = rem - acc;
        } else {
          acc += hb[x];
        }
      }
    }
    const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
    dig = __shfl_sync(FULL, dig, src);
    left = __shfl_sync(FULL, left, src);
    h = __shfl_sync(FULL, h, src);
    pk.prefix = (pk.shift == 32 ? 0u : pk.prefix << 8) | (unsigned)dig;
    pk.shift = shift;
    pk.rem = (int)left;
    pk.done = h == left;
    if (pk.done) break;
  }
  return pk;
}

// a block-wide exclusive scan of v in thread order, *total its sum; every
// thread calls it (two barriers)
__device__ long long block_scan(long long v, Sel* st, long long* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long x = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) st->wsum[w] = incl;
  __syncthreads();
  long long before = 0, all = 0;
  for (int x = 0; x < (int)(blockDim.x >> 5); ++x) {
    const long long s = st->wsum[x];
    before += x < w ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// Phase B: the keys pk names, written to out[0, kb) (and copy, where not
// null) in array order (the least of those a thread wrote, as a ukey,
// returned).  Where
// the passes ended on a whole score with more keys than wanted, those keys
// tie on the score, and the first pk.rem of them in array order (the lower
// positions, where the array is in position order) are taken: one block
// scan of each thread's counts above and tied (packed in one word) places
// every thread's keys.  Every thread calls it.
__device__ unsigned long long gather_ordered(const long long* keys,
                                             long long n, const Pick& pk,
                                             Sel* st, long long* out,
                                             long long* copy = nullptr) {
  const long long per = run_len(n), lo = threadIdx.x * per;
  int above = 0, ties = 0;
  for (long long j = 0; j < per && lo + j < n; ++j) {
    const long long k = keys[lo + j];
    const unsigned hi = key_hi(k);
    if (pk.done ? (hi >> pk.shift) >= pk.prefix : hi > pk.prefix)
      ++above;
    else if (!pk.done && hi == pk.prefix && k != KEY_MIN)
      ++ties;
  }
  long long total;
  const long long before =
      block_scan(((long long)above << 32) | ties, st, &total);
  const long long ties_before = before & 0xFFFFFFFFLL;
  long long o = (before >> 32) + (ties_before < pk.rem ? ties_before : pk.rem);
  long long take = pk.rem - ties_before;
  take = take < 0 ? 0 : take;
  unsigned long long least = ~0ULL;
  for (long long j = 0; j < per && lo + j < n; ++j) {
    const long long k = keys[lo + j];
    const unsigned hi = key_hi(k);
    const bool in =
        (pk.done ? (hi >> pk.shift) >= pk.prefix : hi > pk.prefix) ||
        (!pk.done && hi == pk.prefix && k != KEY_MIN && take-- > 0);
    if (in) {
      if (copy != nullptr) copy[o] = k;
      out[o++] = k;
      least = ukey(k) < least ? ukey(k) : least;
    }
  }
  return least;
}

__device__ __forceinline__ void cmp_swap(long long* k, int i, int l,
                                         bool desc) {
  const long long a = k[i], b = k[l];
  if (desc ? a < b : a > b) {
    k[i] = b;
    k[l] = a;
  }
}

// k[0, n) sorted descending (n a power of two); every thread calls it,
// after a barrier
__device__ void block_sort_desc(long long* k, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = 2 * j * (t / j) + (t % j);
        cmp_swap(k, i, i + j, (i & size) == 0);
      }
      __syncthreads();
    }
  }
}

// The top kb of keys[0, n), sorted descending: at kb <= RANK_SORT_MAX
// gathered into buf and placed by rank into sorted (which it returns),
// above gathered into buf[0, R) (R = pow2(kb), KEY_MIN past kb) and
// sorted there by a bitonic sort (buf returned).  Every thread calls it.
__device__ const long long* block_top_sorted(const long long* keys,
                                             long long n, int kb, int R,
                                             Sel* st, long long* buf,
                                             long long* sorted) {
  const Pick pk = select_hi(keys, n, kb, st);
  gather_ordered(keys, n, pk, st, buf);
  if (kb <= RANK_SORT_MAX) {
    __syncthreads();
    for (int i = threadIdx.x; i < kb; i += blockDim.x) {
      const long long k = buf[i];
      int r = 0;
      for (int j = 0; j < kb; ++j) r += buf[j] > k;
      sorted[r] = k;
    }
    __syncthreads();
    return sorted;
  }
  for (int i = kb + threadIdx.x; i < R; i += blockDim.x) buf[i] = KEY_MIN;
  __syncthreads();
  block_sort_desc(buf, R);
  return buf;
}

// ---------------------------------------------------------------------------
// candidates
// ---------------------------------------------------------------------------

// the probed groups' slots of the candidate vector: group p's start
// (clamped) and length, then the delta
struct Groups {
  const long long* start;
  const long long* len;
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

__device__ __forceinline__ void group_of(long long gid, long long flat_len,
                                         int cap,
                                         const int* __restrict__ offsets,
                                         const int* __restrict__ lens,
                                         long long* start, long long* len) {
  long long s = __ldg(offsets + gid);
  const long long hi = flat_len - cap;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  *start = s;
  *len = __ldg(lens + gid);
}

__device__ __forceinline__ bool valid_row(long long c, long long n_valid,
                                          const unsigned char* mask) {
  return c >= 0 && c < n_valid && (mask == nullptr || __ldg(mask + c) != 0);
}

// stage 1's shared memory: the chunk's keys, the select's histogram and
// state, the count, then the groups (and K6's query signature)
struct Stage1Smem {
  long long* keys;
  long long* sel;  // the chunk's top kb (up to QUANT_KB), position order
  Sel* st;
  int* cnt;
  long long* gs;
  long long* gl;
  unsigned char* tail;
};

__device__ __forceinline__ Stage1Smem stage1_smem(unsigned char* smem,
                                                  int P) {
  Stage1Smem s;
  s.keys = reinterpret_cast<long long*>(smem);
  s.sel = s.keys + CHUNK;
  const int head = (CHUNK + QUANT_KB) * 8;
  s.st = reinterpret_cast<Sel*>(smem + head);
  s.cnt = reinterpret_cast<int*>(smem + head + SEL_BYTES);
  s.gs = reinterpret_cast<long long*>(smem + head + SEL_BYTES + 16);
  s.gl = s.gs + P;
  s.tail = reinterpret_cast<unsigned char*>(s.gl + P);
  return s;
}

size_t stage1_smem_bytes(int P, size_t tail) {
  return (size_t)up16((CHUNK + QUANT_KB) * 8 + SEL_BYTES + 16 + 16LL * P +
                      (long long)tail);
}

// stage 1's end: the block's valid count `mine` summed; the chunk's keys
// keys[0, len) -> its top min(kb, len), in position order, to the query's
// list at slot blockIdx.x, KEY_MIN past them up to kbc; the chunk's count,
// and its keys at NQ ranks of its top kb (as ukeys; 0 where unknown): a
// chunk holding its quantile q's key holds quant_rank(kb, q) keys at or
// above it, which bounds the query's kb-th key from below (stage 2)
__device__ void chunk_out(const Stage1Smem& s, int len, int kb, int mine,
                          const Layout& L, unsigned char* wq) {
  if (threadIdx.x == 0) s.st->kmin = ~0ULL;
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(s.cnt, mine);
  __syncthreads();
  long long* dst =
      reinterpret_cast<long long*>(wq + L.keys) + (long long)blockIdx.x * L.kbc;
  unsigned long long* kq =
      reinterpret_cast<unsigned long long*>(wq + L.kth) +
      (long long)blockIdx.x * NQ;
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(wq + L.cnt)[blockIdx.x] = *s.cnt;
#ifdef PROBE_NO_SELECT
  const bool all = true;
#else
  const bool all = kb >= len;
#endif
  if (all) {
    for (int i = threadIdx.x; i < L.kbc; i += blockDim.x)
      dst[i] = i < len ? s.keys[i] : KEY_MIN;
    if (threadIdx.x < NQ) kq[threadIdx.x] = 0;
    return;
  }
  const Pick pk = select_hi(s.keys, len, kb, s.st);
  unsigned long long least = gather_ordered(
      s.keys, len, pk, s.st, dst, kb <= QUANT_KB ? s.sel : nullptr);
  if (kb <= QUANT_KB) {
    __syncthreads();
    // each key's rank among the kb: the quantiles' keys
    for (int i = threadIdx.x; i < kb; i += blockDim.x) {
      const long long k = s.sel[i];
      int r = 1;
      for (int j = 0; j < kb; ++j) r += s.sel[j] > k;
      for (int q = 0; q < NQ; ++q)
        if (quant_rank(kb, q) == r) kq[q] = ukey(k);
    }
    return;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, least, o);
    least = x < least ? x : least;
  }
  if ((threadIdx.x & 31) == 0) atomicMin(&s.st->kmin, least);
  __syncthreads();
  if (threadIdx.x < NQ)
    kq[threadIdx.x] = threadIdx.x == NQ - 1 ? s.st->kmin : 0;
}

// ---------------------------------------------------------------------------
// K6 stage 1
// ---------------------------------------------------------------------------

template <int KIND>
__global__ void __launch_bounds__(T6)
sig_stage1(const uint32_t* __restrict__ table, const float* __restrict__ norms,
           int W, long long n_valid, const unsigned char* __restrict__ mask,
           const uint32_t* __restrict__ q_sigs,
           const float* __restrict__ q_norms,
           const long long* __restrict__ q_rows, const int* __restrict__ flat,
           long long flat_len, const int* __restrict__ offsets,
           const int* __restrict__ lens, const int* __restrict__ delta,
           const int* __restrict__ plan, int P, int bits, int cap,
           const float* __restrict__ tab, int kb, long long width, Layout L,
           bool pairs, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage1Smem s = stage1_smem(smem, P);
  uint32_t* qs = reinterpret_cast<uint32_t*>(s.tail);
  const int q = blockIdx.y;
  unsigned char* wq = ws + (long long)q * L.per_q;
  const uint32_t* src = q_rows != nullptr ? table + q_rows[q] * W
                                          : q_sigs + (long long)q * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) qs[w] = src[w];
  if (threadIdx.x == 0) *s.cnt = 0;
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
    group_of(gid, flat_len, cap, offsets, lens, s.gs + p, s.gl + p);
    if (blockIdx.x == 0) {
      long long* wg = reinterpret_cast<long long*>(wq + L.groups);
      wg[p] = s.gs[p];
      wg[P + p] = s.gl[p];
    }
  }
  __syncthreads();
  const float qn = q_rows != nullptr ? norms[q_rows[q]] : q_norms[q];
  const Groups g{s.gs, s.gl};
  const long long base = (long long)blockIdx.x * CHUNK;
  const int len = (int)(width - base < CHUNK ? width - base : CHUNK);
  long long c[J6];
  bool ok[J6];
  int n[J6];
#pragma unroll
  for (int j = 0; j < J6; ++j) {
    const int o = threadIdx.x + j * T6;
    c[j] = o < len ? candidate(base + o, g, P, cap, flat, delta) : -1;
  }
#pragma unroll
  for (int j = 0; j < J6; ++j) {
    ok[j] = valid_row(c[j], n_valid, mask);
    n[j] = 0;
  }
  // word-major: the J6 rows' loads of a word (of two words, where pairs:
  // W even, the table 8-byte aligned) go out together
  int w = 0;
  if (pairs) {
    for (; w < W; w += 2) {
      const uint32_t q0 = qs[w], q1 = qs[w + 1];
#pragma unroll
      for (int j = 0; j < J6; ++j) {
        if (ok[j]) {
          const uint2 x =
              __ldg(reinterpret_cast<const uint2*>(table + c[j] * W + w));
          n[j] += KIND == 1 ? (int)(x.x == q0) + (int)(x.y == q1)
                            : __popc(x.x ^ q0) + __popc(x.y ^ q1);
        }
      }
    }
  }
  for (; w < W; ++w) {
    const uint32_t qw = qs[w];
#pragma unroll
    for (int j = 0; j < J6; ++j) {
      if (ok[j]) {
        const uint32_t x = __ldg(table + c[j] * W + w);
        n[j] += KIND == 1 ? (int)(x == qw) : __popc(x ^ qw);
      }
    }
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < J6; ++j) {
    const int o = threadIdx.x + j * T6;
    float sc = -INFINITY;
    if (ok[j]) {
      ++mine;
      sc = __ldg(tab + n[j]);
      if (KIND == 2) {
        const float nr = __ldg(norms + c[j]);
        const float a = __fmaf_rn(nr, nr, __fmul_rn(qn, qn));
        const float d2 = __fmaf_rn(-__fmul_rn(__fmul_rn(2.0f, qn), nr), sc, a);
        sc = -__fsqrt_rn(fmaxf(d2, 0.0f));
      }
    }
    if (o < len) s.keys[o] = make_key(sc, (uint32_t)(base + o));
  }
  chunk_out(s, len, kb, mine, L, wq);
}

// ---------------------------------------------------------------------------
// stage 2 (both kernels)
// ---------------------------------------------------------------------------

size_t stage2_smem_bytes(const Layout& L) {
  const long long n2 = (long long)L.nchunks * L.kbc;
  const int kr = L.R < RANK_SORT_MAX ? L.R : RANK_SORT_MAX;
  return (size_t)(SEL_BYTES + 16 + 8LL * kr + 8LL * RANK_KEYS +
                  (L.R <= SORT_SMEM_KEYS ? 8LL * L.R : 0) +
                  (n2 <= S2_SMEM_KEYS ? 8 * n2 : 0));
}

__global__ void __launch_bounds__(T2)
probe_stage2(const int* __restrict__ flat, const int* __restrict__ delta,
             int P, int cap, int kb, Layout L, unsigned char* ws,
             long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Sel* st = reinterpret_cast<Sel*>(smem);
  long long* total = reinterpret_cast<long long*>(smem + SEL_BYTES);
  long long* kept = reinterpret_cast<long long*>(smem + SEL_BYTES + 16);
  long long* sorted = kept + RANK_KEYS;
  long long* sbuf = sorted + (L.R < RANK_SORT_MAX ? L.R : RANK_SORT_MAX);
  const bool sort_in_smem = L.R <= SORT_SMEM_KEYS;
  long long* lbuf = sbuf + (sort_in_smem ? L.R : 0);
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  unsigned char* wq = ws + (long long)q * L.per_q;
  const long long n2 = (long long)L.nchunks * L.kbc;
  const long long* lst = reinterpret_cast<const long long*>(wq + L.keys);
  if (threadIdx.x == 0) {
    *total = 0;
    st->kmax = 0;
    st->kept = 0;
  }
  if (n2 <= S2_SMEM_KEYS) {
    // the lists to shared memory, 8 loads a thread in flight
    for (long long i0 = threadIdx.x; i0 < n2; i0 += 8 * blockDim.x) {
      long long v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        v[u] = i < n2 ? __ldcg(lst + i) : KEY_MIN;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        if (i < n2) lbuf[i] = v[u];
      }
    }
    lst = lbuf;
  }
  // the candidate count (the chunks' counts summed) and the bound: warp
  // q takes the m-th largest of the chunks' quantile-q keys, m =
  // ceil(kb / quant_rank(kb, q)): m chunks hold quant_rank keys at or
  // above it each, so kb in all; the largest of the NQ is the bound
  const int* cnt = reinterpret_cast<const int*>(wq + L.cnt);
  const unsigned long long* kq =
      reinterpret_cast<const unsigned long long*>(wq + L.kth);
  long long mine = 0;
  for (int i = threadIdx.x; i < L.nchunks; i += blockDim.x) mine += cnt[i];
  unsigned long long bound = 0;
  const int col = threadIdx.x >> 5;
  if (col < NQ) {
    const int m = (kb + quant_rank(kb, col) - 1) / quant_rank(kb, col);
    unsigned long long last = ~0ULL;
    for (int it = 0; it < m && last != 0; ++it) {
      unsigned long long best = 0;
      for (int c = lane; c < L.nchunks; c += 32) {
        const unsigned long long v = kq[c * NQ + col];
        best = v < last && v > best ? v : best;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = __shfl_xor_sync(FULL, best, o);
        best = x > best ? x : best;
      }
      last = best;
    }
    bound = last == ~0ULL ? 0 : last;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mine += __shfl_xor_sync(FULL, mine, o);
    const unsigned long long x = __shfl_xor_sync(FULL, bound, o);
    bound = x > bound ? x : bound;
  }
  __syncthreads();
  if (lane == 0) {
    if (mine)
      atomicAdd(reinterpret_cast<unsigned long long*>(total),
                (unsigned long long)mine);
    atomicMax(&st->kmax, bound);
  }
  __syncthreads();
  const long long* wg = reinterpret_cast<const long long*>(wq + L.groups);
  const Groups g{wg, wg + P};
  long long* o = out + (long long)q * (2 * kb + 1);
  if (threadIdx.x == 0) o[2 * kb] = *total;
  if (n2 <= S2_SMEM_KEYS) {
    // the keys at or above the bound, in no order (up to RANK_KEYS)
    bound = st->kmax;
    for (long long b0 = 0; b0 < n2; b0 += blockDim.x) {
      const long long i = b0 + threadIdx.x;
      const long long k = i < n2 ? lst[i] : KEY_MIN;
      const bool in = i < n2 && ukey(k) >= bound;
      const unsigned b = __ballot_sync(FULL, in);
      int off = 0;
      if (lane == 0 && b) off = atomicAdd(&st->kept, __popc(b));
      off = __shfl_sync(FULL, off, 0) + __popc(b & ((1u << lane) - 1u));
      if (in && off < RANK_KEYS) kept[off] = k;
    }
    __syncthreads();
    const int nk = st->kept;
    if (nk <= RANK_DIRECT) {
      // each kept key's rank among them (keys unique): its place
      for (int i = threadIdx.x; i < nk; i += blockDim.x) {
        const long long k = kept[i];
        int r = 0;
        for (int j = 0; j < nk; ++j) r += kept[j] > k;
        if (r < kb) {
          o[r] = k;
          o[kb + r] = candidate(key_pos(k), g, P, cap, flat, delta);
        }
      }
      return;
    }
    if (nk <= RANK_KEYS) {
      // more: a bitonic sort of them (ties spread thinly over the chunks
      // leave a low bound)
      int r2 = 1;
      while (r2 < nk) r2 <<= 1;
      for (int i = nk + threadIdx.x; i < r2; i += blockDim.x)
        kept[i] = KEY_MIN;
      __syncthreads();
      block_sort_desc(kept, r2);
      for (int j = threadIdx.x; j < kb; j += blockDim.x) {
        o[j] = kept[j];
        o[kb + j] = candidate(key_pos(kept[j]), g, P, cap, flat, delta);
      }
      return;
    }
  }
  // the lists' top kb by the radix select (in position order)
  long long* buf =
      sort_in_smem ? sbuf : reinterpret_cast<long long*>(wq + L.sort);
  const long long* top = block_top_sorted(lst, n2, kb, L.R, st, buf, sorted);
  for (int j = threadIdx.x; j < kb; j += blockDim.x) {
    const long long key = top[j];
    o[j] = key;
    o[kb + j] = candidate(key_pos(key), g, P, cap, flat, delta);
  }
}

// ---------------------------------------------------------------------------
// K7: the embedding, the centroids, the pick, stage 1
// ---------------------------------------------------------------------------

// e[0, E) = the query's count-sketch embedding, from +0: every thread of
// the block calls it (ubuf: 32 floats of shared memory).  Warp 0 adds the
// signed values 32 features a step; the features of a step that share a
// coordinate are added in k order by the lowest of their lanes.
__device__ void build_embedding(float* e, const int* __restrict__ q_idx,
                                const float* __restrict__ q_val, int K,
                                int E, int log2e, float* ubuf) {
  for (int j = threadIdx.x; j < E; j += blockDim.x) e[j] = 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      int h = -1 - lane;
      if (k < K) {
        const uint32_t i = (uint32_t)__ldg(q_idx + k);
        // E 1: a shift by 32, which XLA and numpy define as 0
        h = log2e == 0 ? 0 : (int)((i * CS_H) >> (32 - log2e));
        const float v = __ldg(q_val + k);
        ubuf[lane] = (i * CS_S) >> 31 ? -v : v;
      }
      __syncwarp();
      const unsigned peers = __match_any_sync(FULL, h);
      if (k < K && lane == __ffs(peers) - 1) {
        float acc = e[h];
        for (unsigned m = peers; m; m &= m - 1)
          acc = add_ftz(acc, ubuf[__ffs(m) - 1]);
        e[h] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TP)
ivf_embed(const int* __restrict__ q_idx, const float* __restrict__ q_val,
          int K, int E, int log2e, float* e) {
  __shared__ float ubuf[32];
  build_embedding(e, q_idx, q_val, K, E, log2e, ubuf);
}

// a centroid's ssq unit: U = 32 a window's rounded products in k order
// from +0; U = 1024 its 32 windows' sums in order from +0
__device__ __forceinline__ float ssq_unit(const float* __restrict__ row,
                                          int U) {
  float tot = 0.0f;
  for (int w0 = 0; w0 < U; w0 += 32) {
    float win = 0.0f;
    for (int k = w0; k < w0 + 32; ++k) {
      const float x = __ldg(row + k);
      win = add_ftz(win, mul_ftz(x, x));
    }
    tot = U == 32 ? win : add_ftz(tot, win);
  }
  return tot;
}

// a unit of 32^L rounded products above E 65,536: windows of 32 in k
// order from +0, each level's 32 sums added in order from +0 (acc[lvl]
// holds the open sum of level lvl + 1)
__device__ float ssq_tree(const float* __restrict__ row, int L) {
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float out = 0.0f;
  const long long windows = 1LL << (5 * L - 5);
  for (long long w = 0; w < windows; ++w) {
    float v = 0.0f;
    for (int t = 0; t < 32; ++t) {
      const float x = __ldg(row + w * 32 + t);
      v = add_ftz(v, mul_ftz(x, x));
    }
    int lvl = 1;
    long long ww = w + 1;
    while (lvl < L) {
      acc[lvl] = add_ftz(acc[lvl], v);
      if (ww & 31) break;
      v = acc[lvl];
      acc[lvl] = 0.0f;
      ww >>= 5;
      ++lvl;
    }
    if (lvl == L) out = v;
  }
  return out;
}

// E 8: the leading rows whose squares' sum XLA's vectorized loop takes
// (rounded products); the others are its scalar loop's fused chain
// (ops/candidates.py ssq_vector_rows)
__device__ __forceinline__ int ssq_vector_rows(int C) {
  if (C < 16) return C == 2 || C == 4 || C == 8 ? C : 0;
  const int n = 8 * (C / 8);
  return C < 64 && C % 8 >= 4 ? n + 4 : n;
}

// a block of CPB centroids, 8 lanes each -> their keys (score dot - 0.5
// ssq, position c) in ckeys; e_glob: the embedding built by ivf_embed, or
// null to build it here in shared memory
__global__ void __launch_bounds__(TC)
ivf_centroids(const int* __restrict__ q_idx, const float* __restrict__ q_val,
              int K, const float* __restrict__ cent, int C, int E, int log2e,
              const float* __restrict__ e_glob, long long* ckeys) {
  extern __shared__ __align__(16) float e_s[];
  const float* e = e_glob;
  if (e_glob == nullptr) {
    build_embedding(e_s + 32, q_idx, q_val, K, E, log2e, e_s);
    e = e_s + 32;
  }
  const int lane = threadIdx.x & 31, j = lane & 7, lead = lane & ~7;
  const int c = blockIdx.x * CPB + (threadIdx.x >> 3);
  const bool live = c < C;
  const float* row = cent + (long long)(live ? c : 0) * E;
  // the dot: lane j's chain over k = j mod 8
  float l = 0.0f;
  if (E >= 8)
    for (int k = j; k < E; k += 8) l = fma_ftz(__ldg(row + k), e[k], l);
  float lx[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) lx[x] = __shfl_sync(FULL, l, lead + x);
  // ssq: units of U products, lane j units j, j + 8, ...
  float ssq = 0.0f;
  if (E > 65536) {  // units of 32^L, at most 32 of them, in order
    int L = 3;
    long long U = 32768;
    while (E / U > 32) {
      U <<= 5;
      ++L;
    }
    const int nu = (int)(E / U);
    float slot[4];
    for (int u = j; u < nu; u += 8) slot[u >> 3] = ssq_tree(row + u * U, L);
    for (int u = 0; u < nu; ++u)
      ssq = add_ftz(ssq, __shfl_sync(FULL, slot[u >> 3], lead + (u & 7)));
  } else if (E >= 64) {
    const int U = E <= 1024 ? 32 : 1024, nu = E / U;
    float slot[8];
    for (int u = j; u < nu; u += 8) slot[u >> 3] = ssq_unit(row + u * U, U);
    float part = 0.0f;
    for (int u = 0; u < nu; ++u) {
      const float v = __shfl_sync(FULL, slot[u >> 3], lead + (u & 7));
      if (nu <= 32) {
        ssq = add_ftz(ssq, v);
      } else {  // 64 units (E 65,536): two sums of 32, then in order
        part = add_ftz(part, v);
        if ((u & 31) == 31) {
          ssq = add_ftz(ssq, part);
          part = 0.0f;
        }
      }
    }
  }
  if (!live || j != 0) return;
  float dot;
  if (E < 8) {
    dot = 0.0f;
    for (int k = 0; k < E; ++k) dot = fma_ftz(__ldg(row + k), e[k], dot);
  } else if (c < 8 * (C / 8)) {
    dot = add_ftz(add_ftz(add_ftz(lx[0], lx[1]), add_ftz(lx[2], lx[3])),
                  add_ftz(add_ftz(lx[4], lx[5]), add_ftz(lx[6], lx[7])));
  } else {
    dot = add_ftz(add_ftz(add_ftz(lx[0], lx[4]), add_ftz(lx[2], lx[6])),
                  add_ftz(add_ftz(lx[1], lx[5]), add_ftz(lx[3], lx[7])));
  }
  dot = add_ftz(dot, 0.0f);
  if (E < 64) {
    const bool rounded = E == 8 && c < ssq_vector_rows(C);
    for (int k = 0; k < E; ++k) {
      const float x = __ldg(row + k);
      ssq = rounded ? add_ftz(ssq, mul_ftz(x, x)) : fma_ftz(x, x, ssq);
    }
  }
  float s = sub_ftz(dot, mul_ftz(0.5f, ssq));
  if (E == 1) {  // XLA fuses the one product: fma(c, e, -(0.5 c c))
    const float x = __ldg(row);
    s = fma_ftz(x, e[0], -mul_ftz(0.5f, mul_ftz(x, x)));
  }
  ckeys[c] = make_key(s, (uint32_t)c);
}

// one block: the top `probes` centroid keys, sorted -> the 2 probes
// groups (top, then top + C) in the workspace.  Up to PICK_EXTRACT probes
// the keys are taken one at a time, each the block's largest below the
// last (a warp reduction and an atomic a warp); more, the select.
__global__ void __launch_bounds__(TP)
ivf_pick(long long flat_len, const int* __restrict__ offsets,
         const int* __restrict__ lens, int C, int probes, int cap, Layout L,
         long long ckeys_off, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  Sel* st = reinterpret_cast<Sel*>(smem);
  long long* sorted = reinterpret_cast<long long*>(smem + SEL_BYTES);
  int R = 1;
  while (R < probes) R <<= 1;
  long long* buf = sorted + (R < RANK_SORT_MAX ? R : RANK_SORT_MAX);
  const long long* ck = reinterpret_cast<const long long*>(ws + ckeys_off);
  if (C <= PICK_SMEM_KEYS) {
    long long* kc = buf + R;
    for (int i = threadIdx.x; i < C; i += blockDim.x) kc[i] = ck[i];
    ck = kc;
  }
  if (threadIdx.x < 32) st->wsum[threadIdx.x] = 0;
  __syncthreads();
  const long long* top = sorted;
  if (probes <= PICK_EXTRACT) {
    unsigned long long* slot =
        reinterpret_cast<unsigned long long*>(st->wsum);
    unsigned long long last = ~0ULL;
    for (int p = 0; p < probes; ++p) {
      unsigned long long best = 0;
      for (int i = threadIdx.x; i < C; i += blockDim.x) {
        const unsigned long long u = ukey(ck[i]);
        best = u < last && u > best ? u : best;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = __shfl_xor_sync(FULL, best, o);
        best = x > best ? x : best;
      }
      if ((threadIdx.x & 31) == 0) atomicMax(slot + p, best);
      __syncthreads();
      last = slot[p];
      if (threadIdx.x == 0) sorted[p] = (long long)(last ^ (1ULL << 63));
    }
    __syncthreads();
  } else {
    top = block_top_sorted(ck, C, probes, R, st, buf, sorted);
  }
  long long* wg = reinterpret_cast<long long*>(ws + L.groups);
  const int P = 2 * probes;
  for (int p = threadIdx.x; p < probes; p += blockDim.x) {
    const long long c = key_pos(top[p]);
    group_of(c, flat_len, cap, offsets, lens, wg + p, wg + P + p);
    group_of(c + C, flat_len, cap, offsets, lens, wg + probes + p,
             wg + P + probes + p);
  }
}

// a candidate row's dot with the dense query in jnp.einsum's order, step
// k of it
__device__ __forceinline__ float einsum_step(float acc, float g, float v,
                                             int k) {
  return k == 0 ? mul_ftz(g, v)
                : (k < 8 ? add_ftz(acc, mul_ftz(g, v)) : fma_ftz(g, v, acc));
}

// VEC: Kr a multiple of 4 and the row tables 16-byte aligned, a row read
// 4 indices and 4 values a load
template <int METRIC, bool VEC>
__global__ void __launch_bounds__(T7)
ivf_stage1(const float* __restrict__ q_dense, float qn,
           const int* __restrict__ r_idx, const float* __restrict__ r_val,
           const float* __restrict__ norms, int Kr, long long n_valid,
           const unsigned char* __restrict__ mask,
           const int* __restrict__ flat, const int* __restrict__ delta, int P,
           int cap, int kb, long long width, Layout L, unsigned char* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage1Smem s = stage1_smem(smem, P);
  const long long* wg = reinterpret_cast<const long long*>(ws + L.groups);
  for (int p = threadIdx.x; p < 2 * P; p += blockDim.x) s.gs[p] = wg[p];
  if (threadIdx.x == 0) *s.cnt = 0;
  __syncthreads();
  const Groups g{s.gs, s.gl};
  const long long base = (long long)blockIdx.x * CHUNK;
  const int len = (int)(width - base < CHUNK ? width - base : CHUNK);
  long long c[J7];
  bool ok[J7];
  float acc[J7];
#pragma unroll
  for (int j = 0; j < J7; ++j) {
    const int o = threadIdx.x + j * T7;
    c[j] = o < len ? candidate(base + o, g, P, cap, flat, delta) : -1;
  }
#pragma unroll
  for (int j = 0; j < J7; ++j) {
    ok[j] = valid_row(c[j], n_valid, mask);
    acc[j] = 0.0f;
  }
  // k-major: the J7 rows' loads of a step go out together
  if (VEC) {
    // 8 entries a step (4 where Kr is no multiple of 8); the next step's
    // index and value vectors load while this step's gathers wait
    const int step = (Kr & 7) ? 4 : 8;
    int4 ia[J7][2], ib[J7][2];
    float4 va[J7][2], vb[J7][2];
#pragma unroll
    for (int j = 0; j < J7; ++j) {
      if (!ok[j]) continue;
      const int4* pi = reinterpret_cast<const int4*>(r_idx + c[j] * Kr);
      const float4* pv = reinterpret_cast<const float4*>(r_val + c[j] * Kr);
      ia[j][0] = __ldg(pi);
      va[j][0] = __ldg(pv);
      if (step == 8) {
        ia[j][1] = __ldg(pi + 1);
        va[j][1] = __ldg(pv + 1);
      }
    }
    for (int k0 = 0; k0 < Kr; k0 += step) {
      const int k1 = k0 + step;
#pragma unroll
      for (int j = 0; j < J7; ++j) {
        if (!ok[j] || k1 >= Kr) continue;
        const int4* pi = reinterpret_cast<const int4*>(r_idx + c[j] * Kr + k1);
        const float4* pv =
            reinterpret_cast<const float4*>(r_val + c[j] * Kr + k1);
        ib[j][0] = __ldg(pi);
        vb[j][0] = __ldg(pv);
        if (step == 8) {
          ib[j][1] = __ldg(pi + 1);
          vb[j][1] = __ldg(pv + 1);
        }
      }
      float gv[J7][8];
#pragma unroll
      for (int j = 0; j < J7; ++j) {
        if (!ok[j]) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && step == 4) break;
          gv[j][4 * h] = __ldg(q_dense + ia[j][h].x);
          gv[j][4 * h + 1] = __ldg(q_dense + ia[j][h].y);
          gv[j][4 * h + 2] = __ldg(q_dense + ia[j][h].z);
          gv[j][4 * h + 3] = __ldg(q_dense + ia[j][h].w);
        }
      }
#pragma unroll
      for (int j = 0; j < J7; ++j) {
        if (!ok[j]) continue;
        float a = acc[j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && step == 4) break;
          const int k = k0 + 4 * h;
          a = einsum_step(a, gv[j][4 * h], va[j][h].x, k);
          a = einsum_step(a, gv[j][4 * h + 1], va[j][h].y, k + 1);
          a = einsum_step(a, gv[j][4 * h + 2], va[j][h].z, k + 2);
          a = einsum_step(a, gv[j][4 * h + 3], va[j][h].w, k + 3);
        }
        acc[j] = a;
        ia[j][0] = ib[j][0];
        ia[j][1] = ib[j][1];
        va[j][0] = vb[j][0];
        va[j][1] = vb[j][1];
      }
    }
  } else {
    for (int k = 0; k < Kr; ++k) {
#pragma unroll
      for (int j = 0; j < J7; ++j) {
        if (!ok[j]) continue;
        const float gk = __ldg(q_dense + __ldg(r_idx + c[j] * Kr + k));
        acc[j] = einsum_step(acc[j], gk, __ldg(r_val + c[j] * Kr + k), k);
      }
    }
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < J7; ++j) {
    const int o = threadIdx.x + j * T7;
    float sc = -INFINITY;
    if (ok[j]) {
      ++mine;
      const float nr = __ldg(norms + c[j]);
      if (METRIC == 0) {
        sc = div_ftz(acc[j], fmaxf(mul_ftz(nr, qn), 1e-12f));
      } else {
        const float a = fma_ftz(nr, nr, mul_ftz(qn, qn));
        sc = -sqrt_ftz(fmaxf(add_ftz(a, -2.0f * acc[j]), 0.0f));
      }
    }
    if (o < len) s.keys[o] = make_key(sc, (uint32_t)(base + o));
  }
  chunk_out(s, len, kb, mine, L, ws);
}

// a kernel's dynamic shared memory above the default 48 KB
template <typename F>
int allow_smem(F kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename F>
int smem_ok(F kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  return allow_smem(kernel, smem);
}

bool pow2(long long n) { return n > 0 && (n & (n - 1)) == 0; }

int log2_of(int E) {
  int b = 0;
  while ((1 << b) < E) ++b;
  return b;
}

long long ivf_extra(const Layout& L, int C, int E, long long* ckeys_off,
                    long long* emb_off) {
  *ckeys_off = L.per_q;
  *emb_off = *ckeys_off + up16(8LL * C);
  return *emb_off + (E * 4LL > EMB_SMEM ? up16(4LL * E) : 0);
}

}  // namespace

// K6's workspace (bytes) for Nq queries of `width` candidates in P groups
extern "C" long long sig_probe_workspace_bytes(long long width, int P, int kb,
                                               int NQ) {
  return layout(width, P, kb).per_q * NQ;
}

// K7's workspace (bytes)
extern "C" long long ivf_probe_workspace_bytes(long long width, int probes,
                                               int kb, int C, int E) {
  long long ck, em;
  return ivf_extra(layout(width, 2 * probes, kb), C, E, &ck, &em);
}

// K6: Nq queries (q_sigs [Nq, W] with q_norms [Nq], or q_rows [Nq]);
// npad = pow2(width) (checked, not used); ws: sig_probe_workspace_bytes
extern "C" int sig_probe_launch(
    const void* table, const void* norms, long long R, int W,
    long long n_valid, const void* mask, const void* q_sigs,
    const void* q_norms, const void* q_rows, int NQ, const void* flat,
    long long flat_len, const void* offsets, const void* lens,
    const void* delta, int dcap, const void* plan, int P, int bits, int cap,
    int kind, const void* tab, int kb, int npad, void* ws, void* out,
    void* stream) {
  const long long width = (long long)P * cap + dcap;
  if (NQ <= 0 || NQ > 65535 || W <= 0 || P <= 0 || cap <= 0 || kind < 0 ||
      kind > 2 || kb < 1 || kb > width || !pow2(npad) || npad < width ||
      flat_len < cap || n_valid > R || width > 0x7FFFFFFFLL - CHUNK ||
      ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(width, P, kb);
  const size_t smem1 = stage1_smem_bytes(P, (size_t)W * 4);
  const size_t smem2 = stage2_smem_bytes(L);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid1(L.nchunks, NQ);
  const bool pairs = W % 2 == 0 && ((uintptr_t)table & 7) == 0;
#define SIG_STAGE1_ARGS                                                     \
  (const uint32_t*)table, (const float*)norms, W, n_valid,                  \
      (const unsigned char*)mask, (const uint32_t*)q_sigs,                  \
      (const float*)q_norms, (const long long*)q_rows, (const int*)flat,    \
      flat_len, (const int*)offsets, (const int*)lens, (const int*)delta,   \
      (const int*)plan, P, bits, cap, (const float*)tab, kb, width, L,      \
      pairs, (unsigned char*)ws
  int err;
  switch (kind) {
    case 0:
      if ((err = smem_ok(sig_stage1<0>, smem1))) return err;
      sig_stage1<0><<<grid1, T6, smem1, s>>>(SIG_STAGE1_ARGS);
      break;
    case 1:
      if ((err = smem_ok(sig_stage1<1>, smem1))) return err;
      sig_stage1<1><<<grid1, T6, smem1, s>>>(SIG_STAGE1_ARGS);
      break;
    default:
      if ((err = smem_ok(sig_stage1<2>, smem1))) return err;
      sig_stage1<2><<<grid1, T6, smem1, s>>>(SIG_STAGE1_ARGS);
  }
#undef SIG_STAGE1_ARGS
  if ((err = (int)cudaGetLastError()) || PROBE_UPTO < 4) return err;
  if ((err = smem_ok(probe_stage2, smem2))) return err;
  probe_stage2<<<NQ, T2, smem2, s>>>((const int*)flat, (const int*)delta, P,
                                     cap, kb, L, (unsigned char*)ws,
                                     (long long*)out);
  return (int)cudaGetLastError();
}

// K7: one query; npad = pow2(width), cpad = pow2(C) (checked, not used);
// ws: ivf_probe_workspace_bytes
extern "C" int ivf_probe_launch(
    const void* q_idx, const void* q_val, int K, const void* q_dense,
    float qnorm, const void* cent, int C, int E, int probes,
    const void* r_idx, const void* r_val, const void* norms, long long R,
    int Kr, long long n_valid, const void* mask, const void* flat,
    long long flat_len, const void* offsets, const void* lens,
    const void* delta, int dcap, int cap, int metric, int kb, int npad,
    int cpad, void* ws, void* out, void* stream) {
  const long long width = 2LL * probes * cap + dcap;
  if (K <= 0 || C <= 0 || !pow2(E) || E > MAX_E || probes < 1 ||
      probes > C || probes > MAX_PROBES || Kr <= 0 || cap <= 0 ||
      metric < 0 || metric > 1 || kb < 1 || kb > width || !pow2(npad) ||
      npad < width || !pow2(cpad) || cpad < C || flat_len < cap ||
      n_valid > R || width > 0x7FFFFFFFLL - CHUNK || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int P = 2 * probes;
  const Layout L = layout(width, P, kb);
  long long ckeys_off, emb_off;
  ivf_extra(L, C, E, &ckeys_off, &emb_off);
  unsigned char* w = (unsigned char*)ws;
  long long* ckeys = (long long*)(w + ckeys_off);
  const int log2e = log2_of(E);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  // the embedding and the centroid keys
  const bool e_smem = E * 4LL <= EMB_SMEM;
  float* e_glob = e_smem ? nullptr : (float*)(w + emb_off);
  if (!e_smem) {
    ivf_embed<<<1, TP, 0, s>>>((const int*)q_idx, (const float*)q_val, K, E,
                               log2e, e_glob);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const size_t smemc = e_smem ? (size_t)(E + 32) * 4 : 0;
  if ((err = smem_ok(ivf_centroids, smemc))) return err;
  ivf_centroids<<<(C + CPB - 1) / CPB, TC, smemc, s>>>(
      (const int*)q_idx, (const float*)q_val, K, (const float*)cent, C, E,
      log2e, e_glob, ckeys);
  if ((err = (int)cudaGetLastError()) || PROBE_UPTO < 2) return err;
  // the probed centroids' groups
  int Rp = 1;
  while (Rp < probes) Rp <<= 1;
  const size_t smemp =
      SEL_BYTES + (size_t)(Rp < RANK_SORT_MAX ? Rp : RANK_SORT_MAX) * 8 +
      (size_t)Rp * 8 + (C <= PICK_SMEM_KEYS ? (size_t)C * 8 : 0);
  if ((err = smem_ok(ivf_pick, smemp))) return err;
  ivf_pick<<<1, TP, smemp, s>>>(flat_len, (const int*)offsets,
                                (const int*)lens, C, probes, cap, L,
                                ckeys_off, w);
  if ((err = (int)cudaGetLastError()) || PROBE_UPTO < 3) return err;
  // stage 1 and 2
  const size_t smem1 = stage1_smem_bytes(P, 0);
  const size_t smem2 = stage2_smem_bytes(L);
  const bool vec = Kr % 4 == 0 && ((uintptr_t)r_idx & 15) == 0 &&
                   ((uintptr_t)r_val & 15) == 0;
#define IVF_STAGE1_ARGS                                                     \
  (const float*)q_dense, qnorm, (const int*)r_idx, (const float*)r_val,     \
      (const float*)norms, Kr, n_valid, (const unsigned char*)mask,         \
      (const int*)flat, (const int*)delta, P, cap, kb, width, L, w
#define IVF_STAGE1(M, V)                                                    \
  if ((err = smem_ok(ivf_stage1<M, V>, smem1))) return err;                 \
  ivf_stage1<M, V><<<L.nchunks, T7, smem1, s>>>(IVF_STAGE1_ARGS)
  if (metric == 0) {
    if (vec) {
      IVF_STAGE1(0, true);
    } else {
      IVF_STAGE1(0, false);
    }
  } else {
    if (vec) {
      IVF_STAGE1(1, true);
    } else {
      IVF_STAGE1(1, false);
    }
  }
#undef IVF_STAGE1
#undef IVF_STAGE1_ARGS
  if ((err = (int)cudaGetLastError()) || PROBE_UPTO < 4) return err;
  if ((err = smem_ok(probe_stage2, smem2))) return err;
  probe_stage2<<<1, T2, smem2, s>>>((const int*)flat, (const int*)delta, P,
                                    cap, kb, L, w, (long long*)out);
  return (int)cudaGetLastError();
}
