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
// The work per datum is small (it reads L*K weights and L*K covariances
// and writes at most 4K values, a few KiB), but datum b+1 must see datum
// b's writes, so the B datums run one after another: the kernel is bound
// by the latency of the per-datum chain, not by bytes or operations.  The
// design keeps every device-memory round trip off that chain.
//
// Design: one CTA, warp-specialised.  Warp 0 consumes, warp 1 writes
// back, warps 2 .. P+1 produce; W ring slots in shared memory, each with
// three mbarriers: full (producer -> consumer), empty (consumer ->
// writeback) and written (writeback -> producer).
//   * Producers walk the batch ahead of the consumer, datum n on producer
//     n % P.  Once datum n - W's writes are in device memory (written[],
//     or empty[] in the modes without a writeback warp) a producer fills
//     slot n % W: label, mask, idx, val, |x|^2, for each k the first and
//     next position of its column (head/nxt; one warp match for K <= 32),
//     a column hash (column -> head position), and the gathers
//     w[0..L-1, col] and, for the CW family, cov[0..L-1, col] for ALL L
//     rows, so the rival's covariance never waits for the argmax: 4-byte
//     cp.async, one per distinct column and row, lanes over rows.  Each
//     lane ends the slot with cp.async.mbarrier.arrive.noinc on full[],
//     and lane 0 adds one plain arrive (release) after __syncwarp for the
//     slot's ordinary shared stores: full[] expects 32 + 1 arrivals.
//   * The consumer takes datum n once full[n % W] completes and runs the
//     decision with no block barrier: lane l holds label row l's score
//     (looping when L > 32), summed over K in a fixed order; the rival
//     argmax (lowest index on ties, row 0 when no rival is active —
//     jnp.argmax's rules) is two warp reductions (REDUX) over
//     order-preserving integer keys; v is a butterfly reduction; alpha and
//     g are computed redundantly per lane.  Updates: the lane of the LAST
//     occurrence of each column sums the group's deltas in ascending k (w
//     accumulates duplicate columns) and takes its own covariance value,
//     so the last occurrence wins — XLA CPU's scatter-set order, under
//     which the padding entries (index 0, value 0) overwrite a real
//     column-0 feature's covariance update as the reference does.  The new
//     values go to a log entry in shared memory.  No atomics on the tables
//     (the producers' atomicCAS on the hash decides only where a column
//     sits in it, never a result): a launch is deterministic.
//     counts/active live in shared memory until the end.
//   * The writeback warp (RING_ALL) stores each log entry to device memory
//     in datum order, then __threadfence_block() and a release-arrive on
//     written[], so the consumer's chain holds no device-memory store at
//     all.  In RING_W and DIRECT the consumer reads device memory itself,
//     so it stores its own values and fences before arriving on empty[].
//
// The hazard and how store forwarding closes it.  Slot j is gathered once
// datum j - W's writes are in device memory; datums j-W+1 .. j-1 may since
// have written (y_e, col) and (r_e, col) entries that j read (every bench
// datum carries the numeric feature, one fixed column, and the padding
// column 0).  So the log keeps the last W commits (rows y, r and, per
// distinct column, the new w and cov values), and before using slot j the
// consumer applies entries j-W+1 .. j-1 oldest first: lanes over an
// entry's columns find the column's head position through the slot's hash,
// all lookups first (loads only), then the stores entry by entry with
// __syncwarp between, so the latest write per (row, col) wins.  The log
// holds absolute values, not deltas, so applying an entry that the gather
// already saw changes nothing: a gather that raced a later writeback and
// read its value is still right, and the result does not depend on timing.
// The writer's __threadfence_block() before its release-arrive, and the
// producer's acquire-wait, order every write up to j - W before the
// gathers.  Non-bulk cp.async runs in the generic proxy, like st.global,
// so no fence.proxy.async is needed (a TMA or cp.async.bulk gather would
// need one after the wait).
//
// What bounds it now (measured; PERF.md): a chain of dependent
// shared-memory loads, shuffles and reductions of a few thousand cycles
// per datum on the consumer; forwarding costs a few hundred cycles per log
// entry, so a deeper ring is slower once the producers keep up.
//
// Shapes.  The wrapper picks the mode and W (<= MAX_RING) from the
// shared-memory budget (227 KB) with the same layout as Plan below:
//   RING_ALL — w (and cov) of all L rows prefetched per slot, forwarded;
//   RING_W   — w prefetched and forwarded; cov of rows y and r read by the
//              consumer from device memory after the argmax (on demand; it
//              sees its own earlier stores, so nothing to forward);
//   DIRECT   — no table prefetch (L*K too large for one slot): the consumer
//              reads w and cov from device memory itself.
// All three keep the same decision and update code; only where a table
// value is read from differs.  Duplicate search is O(K) per lane in the
// producer for K > 32, so very large K is slow, never wrong.
//
// Earlier design: 256 threads, one warp per label row for the
// scores, thread 0 alone for the argmax, |x|^2 and v, a covariance gather
// only after the argmax, atomicAdd for w, and about six dependent device
// memory round trips and six __syncthreads() per datum (8.2 us a datum on
// one H100).
//
// Arithmetic is f32 throughout and follows the reference expressions term
// by term; sums run in another order than XLA's, so results agree to a
// tolerance, not bitwise.
//
// The replica grid (train_scan_grid_launch) replaces the JAX package's
// data-parallel train, a shard_map of train_scan_impl over the mesh's dp
// axis (jubatus_tpu/parallel/dp.py _dp_train_fn): ndp model replicas
// stacked [ndp, L, D] (counts, active [ndp, L]), and a batch of ndp * B
// datums of which replica r trains rows [r * B, (r + 1) * B).  Block r of
// a grid of ndp blocks is replica r: it offsets every pointer by r and
// runs the one-block body unchanged, so each replica is bitwise one
// single-block launch on its slice, and a one-block launch (r = 0) is the
// single-replica scan.  Replicas share nothing, so each block takes its
// own SM (the 227 KB opt-in keeps one block an SM): the grid runs ndp
// chains side by side where the single scan runs one.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Method { PERCEPTRON = 0, PA = 1, PA1 = 2, PA2 = 3, CW = 4, AROW = 5,
              NHERD = 6 };
enum Mode { RING_ALL = 0, RING_W = 1, DIRECT = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PRODUCERS = 8;
constexpr int MAX_RING = 8;            // ring depth W <= MAX_RING
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block can opt into
constexpr unsigned BACKOFF_NS = 64;     // producers' and writeback's polls

// Shared-memory layout (bytes).  jubatus_tpu_torch/models/classifier.py
// scan_smem_bytes mirrors `total`.
struct Plan {
  int KP;          // table row stride in floats: K + 1, odd for the even
                   // K the converter gives, so lanes over rows hit
                   // distinct banks
  int ntab;        // tables prefetched per slot: 0, 1 (w) or 2 (w, cov)
  bool log_cov;    // the log carries cov values (RING_ALL with cov)
  int hbits;       // log2 of the slot's column hash size (0: none)
  size_t off_cnt, off_act, off_scr, off_slot, slot_bytes, off_log,
      log_bytes, total;
};

__host__ __device__ inline Plan make_plan(int mode, bool has_cov, int W,
                                          int L, int K) {
  Plan p;
  p.KP = K + 1;
  p.ntab = mode == RING_ALL ? (has_cov ? 2 : 1) : (mode == RING_W ? 1 : 0);
  p.log_cov = mode == RING_ALL && has_cov;
  p.hbits = 0;
  if (p.ntab)                                    // >= 8K entries, >= 32
    for (p.hbits = 5; (1 << p.hbits) < 8 * K; ++p.hbits) {}
  size_t o = 24 * (size_t)W;                     // full, empty, written [W]
  p.off_cnt = o;  o += 4 * (size_t)L;            // counts
  p.off_act = o;  o += 4 * (size_t)L;            // active
  p.off_scr = o;  o += 16 * (size_t)K;           // dy, dr, cy, cr
  // slot: label, mask, |x|^2, pad | idx | val | head | nxt | column hash
  // | ntab tables [L][KP]
  p.slot_bytes = 16 + 16 * (size_t)K + (p.ntab ? 4 << p.hbits : 0) +
                 4 * (size_t)p.ntab * L * p.KP;
  p.off_slot = o; o += (size_t)W * p.slot_bytes;
  // log entry: y, r, n, pad | col | wy | wr [| cy | cr]
  p.log_bytes = p.ntab ? 16 + 4 * (size_t)K * (p.log_cov ? 5 : 3) : 0;
  p.off_log = o;  o += (size_t)W * p.log_bytes;
  p.total = o;
  return p;
}

struct Slot {
  int* meta;   // [0] label, [1] mask bits, [2] |x|^2 bits
  int* idx;
  float* val;
  int* head;   // first position of idx[k]'s column
  int* nxt;    // next position of the same column, -1 after the last
  int* hash;   // open addressing, column -> head position + 1 (0: empty)
  float* tw;   // [L][KP] w at head positions
  float* tc;   // [L][KP] cov at head positions
};

struct LogEntry {
  int* hdr;    // [0] y (-1: no table changed), [1] r, [2] distinct columns
  int* col;
  float *wy, *wr, *cy, *cr;
};

__device__ __forceinline__ Slot slot_at(unsigned char* smem, const Plan& p,
                                        int s, int L, int K) {
  unsigned char* b = smem + p.off_slot + (size_t)s * p.slot_bytes;
  Slot v;
  v.meta = (int*)b;
  v.idx = v.meta + 4;
  v.val = (float*)(v.idx + K);
  v.head = (int*)(v.val + K);
  v.nxt = v.head + K;
  v.hash = v.nxt + K;
  v.tw = (float*)(v.hash + (p.ntab ? 1 << p.hbits : 0));
  v.tc = v.tw + (size_t)L * p.KP;
  return v;
}

__device__ __forceinline__ LogEntry log_at(unsigned char* smem,
                                           const Plan& p, int e, int K) {
  LogEntry g;
  g.hdr = (int*)(smem + p.off_log + (size_t)e * p.log_bytes);
  g.col = g.hdr + 4;
  g.wy = (float*)(g.col + K);
  g.wr = g.wy + K;
  g.cy = g.wr + K;
  g.cr = g.cy + K;
  return g;
}

__device__ __forceinline__ unsigned col_hash(int col, int hbits) {
  return ((unsigned)col * 2654435761u) >> (32 - hbits);
}

// head position of `col` in the slot, or -1 when the datum lacks it.
// The table is at most 1/8 full, so the first probe nearly always
// decides; it is straight-line code, so lookups of several log entries
// overlap.
__device__ __forceinline__ int slot_find(const Slot& sv, int hbits,
                                         int col) {
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = col_hash(col, hbits);
  int t = sv.hash[h];
  if (t != 0 && sv.idx[t - 1] != col) {
    do {
      h = (h + 1u) & mask;
      t = sv.hash[h];
    } while (t != 0 && sv.idx[t - 1] != col);
  }
  return t - 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// release at CTA scope (the PTX default)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// acquire at CTA scope; true once the phase of this parity completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// No wait of this kernel depends on anything outside the block, so one
// that lasts ~20 s means a protocol fault: trap (the launch then fails
// with an error) rather than hold the card forever.
constexpr long long WAIT_LIMIT_CYCLES = 1LL << 35;

// sleep_ns > 0: back off between polls (the producers and the writeback
// warp, which wait a whole ring ahead); the consumer polls without sleeping.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          unsigned sleep_ns = 0) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (sleep_ns) __nanosleep(sleep_ns);
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed;
// .noinc: the barrier's expected count includes this arrival
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// float -> unsigned with the same order (for -inf < finite < +inf), and
// back; NaN does not occur in the scores
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);   // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Optional cycle accounting, a measurement hook (prof is null in the
// service): one lane adds clock64() deltas per stage of its loop and
// writes the sums to prof[base ..] at the end.
struct Stopwatch {
  long long* out;
  long long t, acc[6];
  __device__ explicit Stopwatch(long long* o) : out(o), t(0) {
    for (int i = 0; i < 6; ++i) acc[i] = 0;
    if (out) t = clock64();
  }
  __device__ __forceinline__ void lap(int i) {
    if (out) {
      const long long now = clock64();
      acc[i] += now - t;
      t = now;
    }
  }
  __device__ void flush(int base, int n) {
    if (out)
      for (int i = 0; i < n; ++i) out[base + i] = acc[i];
  }
};

// Producer warp pw of P: fills the slots of datums pw, pw + P, ...
template <int MODE, bool HAS_COV>
__device__ __forceinline__ void produce(
    unsigned char* smem, const Plan& pl, uint64_t* full, uint64_t* freed,
    const float* w, const float* cov, const int32_t* __restrict__ indices,
    const float* __restrict__ values, const int32_t* __restrict__ labels,
    const float* __restrict__ mask, int B, int K, int L, long long D, int W,
    int P, int pw, int lane, long long* prof) {
  const int KP = pl.KP;
  Stopwatch sw(pw == 0 && lane == 0 ? prof : nullptr);
  for (int n = pw; n < B; n += P) {
    const int s = n % W;
    const unsigned u = (unsigned)(n / W);
    // this datum's batch entries, loaded before the wait so their latency
    // hides behind it
    const long long row = (long long)n * K;
    const float mk = mask[n];
    const int lb = labels[n];
    int i0 = 0;
    float v0 = 0.0f;
    if (lane < K) {
      i0 = indices[row + lane];
      v0 = values[row + lane];
    }
    // datum n - W's writes are in device memory
    mbar_wait(&freed[s], (u & 1u) ^ 1u, BACKOFF_NS);
    sw.lap(0);
    const Slot sv = slot_at(smem, pl, s, L, K);
    if (lane == 0) {
      sv.meta[0] = lb;
      sv.meta[1] = __float_as_int(mk);
    }
    if (mk > 0.0f) {                       // uniform over the warp
      if (lane < K) {
        sv.idx[lane] = i0;
        sv.val[lane] = v0;
      }
      for (int k = lane + 32; k < K; k += 32) {
        sv.idx[k] = indices[row + k];
        sv.val[k] = values[row + k];
      }
      if (K <= 32) {
        // duplicate groups in one warp match (columns are >= 0, so the
        // idle lanes' keys -1 - lane match nothing)
        const unsigned grp = __match_any_sync(FULL, lane < K ? i0 : -1 - lane);
        if (lane < K) {
          const unsigned above = grp & ~((2u << lane) - 1u);
          sv.head[lane] = __ffs(grp) - 1;
          sv.nxt[lane] = above ? __ffs(above) - 1 : -1;
        }
      } else {
        __syncwarp();
        for (int k = lane; k < K; k += 32) {
          const int col = sv.idx[k];
          int h = k, nx = -1;
          for (int k2 = 0; k2 < k; ++k2)
            if (sv.idx[k2] == col) { h = k2; break; }
          for (int k2 = k + 1; k2 < K; ++k2)
            if (sv.idx[k2] == col) { nx = k2; break; }
          sv.head[k] = h;
          sv.nxt[k] = nx;
        }
      }
      if (MODE != DIRECT)
        for (int i = lane; i < (1 << pl.hbits); i += 32) sv.hash[i] = 0;
      __syncwarp();
      // |x|^2, off the consumer's chain
      float sq = 0.0f;
      for (int k = lane; k < K; k += 32) sq += sv.val[k] * sv.val[k];
      sq = warp_allsum(sq);
      if (lane == 0) sv.meta[2] = __float_as_int(sq);
      if (MODE != DIRECT) {
        // the column hash the consumer's forwarding probes
        const unsigned hmask = (1u << pl.hbits) - 1u;
        for (int k = lane; k < K; k += 32) {
          if (sv.head[k] != k) continue;
          unsigned h = col_hash(sv.idx[k], pl.hbits);
          while (atomicCAS(&sv.hash[h], 0, k + 1) != 0) h = (h + 1u) & hmask;
        }
      }
      sw.lap(1);
      if (MODE != DIRECT) {
        // one 4-byte copy per (row, distinct column): distinct columns
        // one after another, lanes over rows
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int kl = k0 + lane;
          unsigned heads = __ballot_sync(FULL, kl < K && sv.head[kl] == kl);
          while (heads) {
            const int k = k0 + __ffs(heads) - 1;
            heads &= heads - 1u;
            const int col = sv.idx[k];
            for (int l = lane; l < L; l += 32) {
              const long long g = (long long)l * D + col;
              cp_async4(&sv.tw[l * KP + k], w + g);
              if (MODE == RING_ALL && HAS_COV)
                cp_async4(&sv.tc[l * KP + k], cov + g);
            }
          }
        }
      }
    }
    cp_async_arrive(&full[s]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[s]);  // releases the st.shared above
    sw.lap(2);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  sw.flush(8, 3);
}

// RING_ALL: the writeback warp stores each committed log entry to device
// memory, in datum order, then frees the slot of datum e + W (written[]).
template <bool HAS_COV>
__device__ __forceinline__ void write_back(
    unsigned char* smem, const Plan& pl, uint64_t* empty, uint64_t* written,
    float* w, float* cov, int B, int K, long long D, int W, int lane,
    long long* prof) {
  Stopwatch sw(lane == 0 ? prof : nullptr);
  int s = 0;
  unsigned u = 0;
  for (int e = 0; e < B; ++e) {
    mbar_wait(&empty[s], u & 1u, BACKOFF_NS);   // e consumed
    sw.lap(0);
    const LogEntry le = log_at(smem, pl, s, K);
    const int ye = le.hdr[0];
    if (ye >= 0) {
      const int re = le.hdr[1], ne = le.hdr[2];
      for (int m = lane; m < ne; m += 32) {
        const long long gy = (long long)ye * D + le.col[m];
        const long long gr = (long long)re * D + le.col[m];
        w[gy] = le.wy[m];
        w[gr] = le.wr[m];
        if (HAS_COV) {
          cov[gy] = le.cy[m];
          cov[gr] = le.cr[m];
        }
      }
    }
    // these stores before any gather issued after written[s] completes
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&written[s]);
    sw.lap(1);
    if (++s == W) {
      s = 0;
      ++u;
    }
  }
  sw.flush(12, 2);
}

template <int MODE, bool HAS_COV>
__device__ __forceinline__ void consume(
    unsigned char* smem, const Plan& pl, uint64_t* full, uint64_t* empty,
    float* w, float* cov, int* s_cnt, int* s_act, int B, int K, int L,
    long long D, int method, float c, int W, int lane, long long* prof) {
  constexpr bool RING = MODE != DIRECT;
  constexpr bool LOGCOV = MODE == RING_ALL && HAS_COV;
  constexpr bool DEFER = MODE == RING_ALL;   // the writeback warp stores
  const int KP = pl.KP;
  float* s_dy = (float*)(smem + pl.off_scr);
  float* s_dr = s_dy + K;
  float* s_cy = s_dr + K;
  float* s_cr = s_cy + K;
  Stopwatch sw(lane == 0 ? prof : nullptr);
  int s = 0;
  unsigned u = 0;
  for (int n = 0; n < B; ++n) {
    mbar_wait(&full[s], u & 1u);
    sw.lap(0);
    const Slot sv = slot_at(smem, pl, s, L, K);
    const int y = sv.meta[0];
    const float mk = __int_as_float(sv.meta[1]);
    bool wrote = false;
    LogEntry lg;
    if (RING) lg = log_at(smem, pl, s, K);   // entry n replaces n - W

    // value of table row l at position k (its column's head position)
    auto w_at = [&](int l, int k) -> float {
      if (RING) return sv.tw[l * KP + sv.head[k]];
      return w[(long long)l * D + sv.idx[k]];
    };
    auto cov_at = [&](int l, int k) -> float {
      if (MODE == RING_ALL) return sv.tc[l * KP + sv.head[k]];
      return cov[(long long)l * D + sv.idx[k]];
    };

    if (mk > 0.0f) {
      // 1. store forwarding: commits n-W+1 .. n-1, oldest first.  Lanes
      // over an entry's distinct columns find their head position in the
      // slot through its column hash.  For K <= 32 every entry's lookups
      // and values are gathered into registers first (loads only, all
      // independent), then stored entry by entry with __syncwarp between,
      // so that a later entry's write to a (row, column) lands last.
      if (RING) {
        const int e0 = n - W + 1 > 0 ? n - W + 1 : 0;
        int le_pos = e0 == 0 ? 0 : (s + 1 == W ? 0 : s + 1);   // e0 % W
        if (K <= 32) {
          int fk[MAX_RING - 1], fy[MAX_RING - 1], fr[MAX_RING - 1];
          float fwy[MAX_RING - 1], fwr[MAX_RING - 1];
          float fcy[MAX_RING - 1], fcr[MAX_RING - 1];
#pragma unroll
          for (int i = 0; i < MAX_RING - 1; ++i) {
            fk[i] = -1;
            if (e0 + i < n) {
              const LogEntry le = log_at(smem, pl, le_pos, K);
              if (++le_pos == W) le_pos = 0;
              fy[i] = le.hdr[0];
              fr[i] = le.hdr[1];
              if (fy[i] >= 0 && lane < le.hdr[2]) {
                fwy[i] = le.wy[lane];
                fwr[i] = le.wr[lane];
                if (LOGCOV) {
                  fcy[i] = le.cy[lane];
                  fcr[i] = le.cr[lane];
                }
                fk[i] = slot_find(sv, pl.hbits, le.col[lane]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < MAX_RING - 1; ++i) {
            if (e0 + i >= n) break;              // uniform
            const int k = fk[i];
            if (k >= 0) {
              sv.tw[fy[i] * KP + k] = fwy[i];
              sv.tw[fr[i] * KP + k] = fwr[i];
              if (LOGCOV) {
                sv.tc[fy[i] * KP + k] = fcy[i];
                sv.tc[fr[i] * KP + k] = fcr[i];
              }
            }
            __syncwarp();
          }
        } else {
          for (int e = e0; e < n; ++e) {
            const LogEntry le = log_at(smem, pl, le_pos, K);
            if (++le_pos == W) le_pos = 0;
            const int ye = le.hdr[0];
            if (ye < 0) continue;               // uniform
            const int re = le.hdr[1], ne = le.hdr[2];
            for (int m = lane; m < ne; m += 32) {
              const int k = slot_find(sv, pl.hbits, le.col[m]);
              if (k < 0) continue;
              sv.tw[ye * KP + k] = le.wy[m];
              sv.tw[re * KP + k] = le.wr[m];
              if (LOGCOV) {
                sv.tc[ye * KP + k] = le.cy[m];
                sv.tc[re * KP + k] = le.cr[m];
              }
            }
            __syncwarp();
          }
        }
      }
      sw.lap(1);

      // 2. scores; the rival argmax (first maximum; row 0 when no rival
      // is active) as a max over order-preserving integer keys, then the
      // lowest row holding it.  Non-candidates take -inf's key, as the
      // reference's where(active, s, -inf) does.
      const float sq = __int_as_float(sv.meta[2]);    // |x|^2, producer's
      unsigned bkey = order_key(-INFINITY);
      float sy = 0.0f;
      int bi = lane;
      for (int c0 = 0; c0 < L; c0 += 32) {
        const int l = c0 + lane;
        float sc = 0.0f;
        if (l < L) {
#pragma unroll 16
          for (int k = 0; k < K; ++k) sc += w_at(l, k) * sv.val[k];
          const unsigned key = order_key(sc);
          if (l != y && s_act[l] && key > bkey) {
            bkey = key;
            bi = l;
          }
        }
        if (c0 == (y & ~31)) sy = __shfl_sync(FULL, sc, y & 31);
      }
      const unsigned kmax = __reduce_max_sync(FULL, bkey);
      const int r = (int)__reduce_min_sync(
          FULL, bkey == kmax ? (unsigned)bi : 0xffffffffu);
      const float best = from_order_key(kmax);
      const float margin = sy - best;
      __syncwarp();
      if (lane == 0) {
        s_act[y] = 1;
        s_cnt[y] += 1;
      }
      const bool ok = isfinite(best) && sq > 0.0f;   // uniform
      sw.lap(2);

      if (ok) {
        // 3. step sizes
        float a = 0.0f, g = 0.0f;
        if (!HAS_COV) {
          if (method == PERCEPTRON) {
            a = margin <= 0.0f ? 1.0f : 0.0f;
          } else {
            const float loss = 1.0f - margin;
            float tau;
            if (method == PA) tau = loss / (2.0f * sq);
            else if (method == PA1) tau = fminf(c, loss / (2.0f * sq));
            else tau = loss / (2.0f * sq + 0.5f / c);
            a = loss > 0.0f ? tau : 0.0f;
          }
        } else {
          float vp = 0.0f;
          for (int k = lane; k < K; k += 32) {
            const float x = sv.val[k];
            const float cy = cov_at(y, k), cr = cov_at(r, k);
            s_cy[k] = cy;
            s_cr[k] = cr;
            vp += x * x * (cy + cr);
          }
          const float v = warp_allsum(vp);
          if (method == AROW) {
            const float beta = 1.0f / (v + c);
            const bool gate = margin < 1.0f;
            a = gate ? fmaxf(0.0f, 1.0f - margin) * beta : 0.0f;
            g = gate ? beta : 0.0f;              // ncy = cy - g*cy*cy*x2
          } else if (method == CW) {
            const float phi = c;
            const float t = 1.0f + 2.0f * phi * margin;
            const float inner = t * t - 8.0f * phi * (margin - phi * v);
            const float gamma = (-t + sqrtf(fmaxf(inner, 0.0f))) /
                                (4.0f * phi * fmaxf(v, 1e-12f));
            a = fmaxf(0.0f, gamma);
            g = 2.0f * a * phi;                  // ncy = 1/(1/cy + g*x2)
          } else {  // NHERD
            const bool gate = margin < 1.0f;
            a = gate ? fmaxf(0.0f, 1.0f - margin) / (v + c) : 0.0f;
            g = gate ? (2.0f * c + c * c * v) : 0.0f;   // ncy = cy/(1+g*x2)
          }
        }
        for (int k = lane; k < K; k += 32) {
          const float x = sv.val[k];
          s_dy[k] = HAS_COV ? a * s_cy[k] * x : a * x;
          s_dr[k] = HAS_COV ? -a * s_cr[k] * x : -a * x;
        }
        __syncwarp();
        sw.lap(3);

        // 4. one new value per distinct column, by its last occurrence:
        // into the log (RING) and, unless the writeback warp stores it,
        // into device memory
        int base = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const bool last = k < K && sv.nxt[k] < 0;
          const unsigned bal = __ballot_sync(FULL, last);
          if (last) {
            const int col = sv.idx[k];
            float wy = w_at(y, k), wr = w_at(r, k);
            // the group's deltas in ascending k (independent loads)
#pragma unroll 4
            for (int t = sv.head[k]; t <= k; ++t) {
              if (sv.idx[t] != col) continue;
              wy += s_dy[t];
              wr += s_dr[t];
            }
            float ncy = 0.0f, ncr = 0.0f;
            if (HAS_COV) {
              const float x = sv.val[k], x2 = x * x;
              const float cy = s_cy[k], cr = s_cr[k];
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
            }
            if (!DEFER) {
              const long long gy = (long long)y * D + col;
              const long long gr = (long long)r * D + col;
              w[gy] = wy;
              w[gr] = wr;
              if (HAS_COV) {
                cov[gy] = ncy;
                cov[gr] = ncr;
              }
            }
            if (RING) {
              const int m = base + __popc(bal & ((1u << lane) - 1u));
              lg.col[m] = col;
              lg.wy[m] = wy;
              lg.wr[m] = wr;
              if (LOGCOV) {
                lg.cy[m] = ncy;
                lg.cr[m] = ncr;
              }
            }
          }
          base += __popc(bal);
        }
        if (RING && lane == 0) {
          lg.hdr[1] = r;
          lg.hdr[2] = base;
        }
        wrote = true;
        sw.lap(4);
      }
    }
    if (RING && lane == 0) lg.hdr[0] = wrote ? y : -1;
    // commit: this datum's device-memory stores (if the consumer makes
    // them) before the slot is refilled and so before any later gather;
    // the log needs only the release of the arrive
    if (!DEFER) __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    sw.lap(5);
    if (++s == W) {
      s = 0;
      ++u;
    }
  }
  sw.flush(0, 6);
}

// Warp 0 consumes, warp 1 writes back (RING_ALL; idle otherwise), warps
// 2 .. P+1 produce.  One block a launch, so one block per SM: the bound
// lets ptxas give each thread up to 65,536 / 320 registers.  Without the
// 1, under -ftz=true ptxas kept the RING_ALL kernels near 96 registers
// and spilled (PERF.md).
template <int MODE, bool HAS_COV>
__global__ void __launch_bounds__(32 * (2 + MAX_PRODUCERS), 1)
train_scan_kernel(float* w, float* cov, int32_t* counts, uint8_t* active,
                  const int32_t* __restrict__ indices,
                  const float* __restrict__ values,
                  const int32_t* __restrict__ labels,
                  const float* __restrict__ mask, int B, int K, int L,
                  long long D, int method, float c, int W,
                  long long* prof) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool DEFER = MODE == RING_ALL;
  {
    // block r is replica r of a replica grid (0 in a one-block launch)
    const long long r = blockIdx.x, table = (long long)L * D;
    w += r * table;
    if (HAS_COV) cov += r * table;
    counts += r * L;
    active += r * L;
    indices += r * B * K;
    values += r * B * K;
    labels += r * B;
    mask += r * B;
    if (prof) prof += r * 16;
  }
  const Plan pl = make_plan(MODE, HAS_COV, W, L, K);
  uint64_t* full = (uint64_t*)smem;
  uint64_t* empty = full + W;
  uint64_t* written = empty + W;
  int* s_cnt = (int*)(smem + pl.off_cnt);
  int* s_act = (int*)(smem + pl.off_act);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = (int)(blockDim.x >> 5) - 2;

  if (tid == 0) {
    for (int i = 0; i < W; ++i) {
      mbar_init(&full[i], 33);     // 32 cp.async arrivals + lane 0's
      mbar_init(&empty[i], 1);     // the consumer's lane 0
      mbar_init(&written[i], 1);   // the writeback warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int l = tid; l < L; l += blockDim.x) {
    s_cnt[l] = counts[l];
    s_act[l] = active[l] ? 1 : 0;
  }
  __syncthreads();

  if (warp >= 2) {
    produce<MODE, HAS_COV>(smem, pl, full, DEFER ? written : empty, w, cov,
                           indices, values, labels, mask, B, K, L, D, W, P,
                           warp - 2, lane, prof);
    return;
  }
  if (warp == 1) {
    if (DEFER)
      write_back<HAS_COV>(smem, pl, empty, written, w, cov, B, K, D, W, lane,
                          prof);
    return;
  }
  consume<MODE, HAS_COV>(smem, pl, full, empty, w, cov, s_cnt, s_act, B, K,
                         L, D, method, c, W, lane, prof);
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    counts[l] = s_cnt[l];
    active[l] = (uint8_t)s_act[l];
  }
}

template <int MODE, bool HAS_COV>
int launch(void* w, void* cov, void* counts, void* active,
           const void* indices, const void* values, const void* labels,
           const void* mask, int B, int K, int L, long long D, int method,
           float c, int W, int P, int ndp, long long* prof,
           cudaStream_t stream) {
  const size_t smem = make_plan(MODE, HAS_COV, W, L, K).total;
  auto kernel = train_scan_kernel<MODE, HAS_COV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<ndp, 32 * (2 + P), smem, stream>>>(
      (float*)w, (float*)cov, (int32_t*)counts, (uint8_t*)active,
      (const int32_t*)indices, (const float*)values, (const int32_t*)labels,
      (const float*)mask, B, K, L, D, method, c, W, prof);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes the kernel takes for (mode, method family, ring
// depth, L, K): what the wrapper's scan_smem_bytes must agree with.
extern "C" long long train_scan_smem_bytes(int mode, int has_cov, int ring,
                                           int L, int K) {
  return (long long)make_plan(mode, has_cov != 0, ring, L, K).total;
}

// The launch with cycle accounting: prof (long long[16] a replica, zeroed
// by the caller) receives each block's consumer cycles in stages 0-5 (wait
// for the slot, forwarding, scores and argmax, step sizes, updates,
// commit), the first producer warp's in 8-10 (wait for a free slot,
// staging, gathers) and the writeback warp's in 12-13 (wait, stores).  B
// is the datums of ONE replica; ndp blocks run replica r on rows
// [r * B, (r + 1) * B) of the batch and tables r of the stacked state.  A
// measurement hook: the service never passes prof.
extern "C" int train_scan_grid_launch_profiled(
    void* w, void* cov, void* counts, void* active, const void* indices,
    const void* values, const void* labels, const void* mask, int B, int K,
    int L, long long D, int method, float c, int mode, int ring,
    int producers, int ndp, void* stream, void* prof) {
  const bool has_cov = method >= CW;
  if (ring < 1 || ring > MAX_RING || producers < 1 ||
      producers > MAX_PRODUCERS ||
      producers > ring || mode < RING_ALL || mode > DIRECT ||
      (mode == RING_W && !has_cov) || ndp < 1 || ndp > 65535 ||
      make_plan(mode, has_cov, ring, L, K).total > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define TS_LAUNCH(M, H)                                                    \
  launch<M, H>(w, cov, counts, active, indices, values, labels, mask, B, K, \
               L, D, method, c, ring, producers, ndp, (long long*)prof, st)
  if (has_cov) {
    if (mode == RING_ALL) return TS_LAUNCH(RING_ALL, true);
    if (mode == RING_W) return TS_LAUNCH(RING_W, true);
    return TS_LAUNCH(DIRECT, true);
  }
  if (mode == RING_ALL) return TS_LAUNCH(RING_ALL, false);
  return TS_LAUNCH(DIRECT, false);
#undef TS_LAUNCH
}

// The replica grid, the one C entry of the scan (a single-replica scan is
// the grid at ndp 1): every pointer and the stream as void*; mode (Mode),
// ring depth 1 <= W <= 8 and producer warps 1 <= P <= W as the wrapper
// chose them; ndp blocks, block r replica r (B datums a replica, state
// stacked [ndp, L, D] / [ndp, L]; cov [ndp, L, D] for the CW family,
// unread otherwise).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int train_scan_grid_launch(void* w, void* cov, void* counts,
                                      void* active, const void* indices,
                                      const void* values, const void* labels,
                                      const void* mask, int B, int K, int L,
                                      long long D, int method, float c,
                                      int mode, int ring, int producers,
                                      int ndp, void* stream) {
  return train_scan_grid_launch_profiled(w, cov, counts, active, indices,
                                         values, labels, mask, B, K, L, D,
                                         method, c, mode, ring, producers,
                                         ndp, stream, nullptr);
}
