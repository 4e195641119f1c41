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
// The replica grid (regression_scan_grid_launch) replaces the JAX
// package's data-parallel train, a shard_map of train_scan_impl over the
// mesh's dp axis (jubatus_tpu/parallel/dp.py _dp_reg_train_fn): ndp
// replicas of w stacked [ndp, D] and a batch of ndp * B datums, replica r
// training rows [r * B, (r + 1) * B).  Block r of a grid of ndp blocks is
// replica r: it offsets every pointer by r and runs the one-block body
// unchanged, so each replica is bitwise one single-block launch on its
// slice, and a one-block launch (r = 0) is the single-replica scan.
//
// What bounds it: datum i+1 reads what datum i wrote, so the B datums run
// one after another.  Each reads K weights and writes at most K — a few
// hundred bytes — so the kernel is bound by the latency of the per-datum
// chain, far above its bytes bound.  The design keeps every device-memory
// access and every warp match off that chain.
//
// Design: one CTA, warp-specialised.  Warp 0 consumes, warp 1 writes
// back, warps 2 .. P+1 produce.  The batch is cut into blocks of T datums;
// a ring of S block slots lives in shared memory, each with three
// mbarriers: full (producers -> consumer), done (consumer -> writeback)
// and released (writeback and consumer -> producers).
//   * The producer warps prepare block n together, in block order, with a
//     named barrier between their phases, once released[n % S] says that
//     block n - S is written back and no longer forwarded from: they stage
//     the block's values, targets and mask; dedupe its columns through the
//     slot's hash (atomicCAS decides only where a column sits, never a
//     result), numbering the distinct columns 0 .. ndist-1 and giving
//     every entry its number; per datum they compute |x|^2 in the lane
//     order and butterfly of the consumer's reduction, and group each
//     32-entry chunk's equal columns by warp match (the group's lowest
//     lane, its leader, gets the mask of the lanes whose deltas it adds);
//     per distinct column they find its newest copy among the older
//     blocks still in flight (lookups in their read-only hashes) and
//     gather w[col] into the block's value table with a 4-byte cp.async.  Each producer thread ends the block
//     with cp.async.mbarrier.arrive.noinc on full[], and one thread adds
//     a plain (release) arrive after the named barrier: full[] expects
//     32P + 1 arrivals.
//   * The consumer takes block n once full[] completes.  It first copies
//     each forwarded column's value from the newest older table that holds
//     it (lanes in parallel, once a block), then arrives on the released[]
//     of block n - S + 1, whose table no later block reads.  Per datum:
//     read K table values from shared memory, multiply, one butterfly for
//     pred, the step, then each group's leader adds its own delta and its
//     members' (shuffled from their lanes) in ascending k into the table,
//     and __syncwarp (between 32-entry chunks too, for K > 32).  No
//     global load or store, no warp match, no atomic.
//   * The writeback warp stores a finished block's distinct columns (no
//     two are equal, so in any order), then __threadfence_block() and a
//     release-arrive on released[].  It needs the consumer's arrive too,
//     so a slot is refilled only when its writes are in device memory and
//     no later block forwards from it.  Non-bulk cp.async runs in the
//     generic proxy, like st.global, so no proxy fence is needed.
//
// The hazard across blocks.  Block n's gather may run before blocks
// n-S+1 .. n-1 are written back, and may even race their writeback; the
// forwarded copy overwrites whatever it read for a column those blocks
// hold.  Blocks up to n - S were written back before the gather.  The
// consumer reaches block n only after finishing n - 1, so the older
// tables hold their final values when it copies from them.
//
// Bits.  The table values are the weights the previous kernel (one warp
// reading and writing device memory) read; pred and |x|^2 are summed in
// its lane order (lane l holds entries l, l+32, ..., products rounded
// before the sums, then the xor butterfly); each column gets its deltas in
// ascending k.  A group member whose value has the same bits as the
// member before it and is a signed zero adds the same zero (or NaN) delta,
// and (x + z) + z == x + z, so the producers leave such members out: a
// datum's padding entries cost one add.  So w is bitwise equal to that
// kernel's when both are built with the same flags, and two launches give
// the same bits.
//
// What bounds it now (measured, PERF.md): the consumer's chain, about 430
// cycles a datum on an H100 (a shared-memory table read, the butterfly,
// the step's IEEE division, the group's add and store, __syncwarp); the
// consumer is compiled per method and for K 16 and 32, so the chain has
// no loop or branch.  The producers keep up from P 6 on.  The previous
// kernel, one warp reading and writing w in device memory, spent about
// 80% of its ~2,200 cycles a datum in the gather and in the stores
// before the next datum's gather.
//
// Shapes.  The wrapper plans T, S and P (models/regression.py
// reg_scan_plan) from the shared-memory budget (227 KB) with the layout of
// Plan below; T = 1 at K 4096.  Arithmetic is float32 with IEEE division,
// products rounded before they are summed (__fmul_rn keeps nvcc from
// contracting them into an FMA), as XLA evaluates the scan.  Built with
// -ftz=true (kernels/build.py): subnormal inputs read as zero and
// subnormal results flush, as XLA's CPU backend and the TPU compute; so at
// c ~ 3.4e38 PA2's 0.5/c is 0 here as there.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Method { PA = 0, PA1 = 1, PA2 = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PRODUCERS = 8;
constexpr int MAX_RING = 8;             // ring depth S <= MAX_RING
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block can opt into
constexpr unsigned BACKOFF_NS = 64;     // producers' and writeback's polls
constexpr int PRODUCER_BAR = 1;         // named barrier of the producers

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Shared-memory layout (bytes).  jubatus_tpu_torch/models/regression.py
// reg_scan_smem_bytes mirrors `total`.
struct Plan {
  int NT;          // entries (and table capacity) of a block: T * K
  int hbits;       // log2 of the slot's column hash size (>= 2 NT, >= 32)
  size_t off_slot, slot_bytes, total;
};

__host__ __device__ inline Plan make_plan(int T, int S, int K) {
  Plan p;
  p.NT = T * K;
  for (p.hbits = 5; (1 << p.hbits) < 2 * p.NT; ++p.hbits) {}
  p.off_slot = align16(24 * (size_t)S);          // full, done, released [S]
  // slot: hdr[4] | meta[T] (target, mask, |x|^2, adds) | val, eid, grp [NT]
  // | tab, col, fwd_dst, fwd_src [NT] | hash keys, hash ids [2^hbits]
  p.slot_bytes = align16(16 + 16 * (size_t)T + 28 * (size_t)p.NT +
                         8 * ((size_t)1 << p.hbits));
  p.total = p.off_slot + (size_t)S * p.slot_bytes;
  return p;
}

struct Slot {
  int* hdr;      // [0] distinct columns, [1] forwarded columns, [2] datums
  float4* meta;  // per datum: target, mask, |x|^2, and (int bits) the most
                 // deltas a chunk leader adds beyond its own
  float* val;
  int* eid;      // table number of each entry
  unsigned* grp; // at a chunk leader: the lanes whose deltas it adds
                 // (itself first); 0 elsewhere
  float* tab;    // value of each distinct column
  int* col;      // its column
  int* fdst;     // forwarded: table number here ...
  int* fsrc;     // ... and slot * NT + table number of the newest copy
  int* hkey;     // open addressing, column + 1 (0: empty)
  int* hid;      // table number of the key
};

__device__ __forceinline__ Slot slot_at(unsigned char* smem, const Plan& p,
                                        int s, int T) {
  unsigned char* b = smem + p.off_slot + (size_t)s * p.slot_bytes;
  Slot v;
  v.hdr = (int*)b;
  v.meta = (float4*)(b + 16);
  v.val = (float*)(v.meta + T);
  v.eid = (int*)(v.val + p.NT);
  v.grp = (unsigned*)(v.eid + p.NT);
  v.tab = (float*)(v.grp + p.NT);
  v.col = (int*)(v.tab + p.NT);
  v.fdst = v.col + p.NT;
  v.fsrc = v.fdst + p.NT;
  v.hkey = v.fsrc + p.NT;
  v.hid = v.hkey + (1 << p.hbits);
  return v;
}

__device__ __forceinline__ unsigned col_hash(int col, int hbits) {
  return ((unsigned)col * 2654435761u) >> (32 - hbits);
}

// table number of `col` in a slot's hash, or -1 when its block lacks it
__device__ __forceinline__ int slot_find(const Slot& sv, int hbits,
                                         int col) {
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = col_hash(col, hbits);
  int key = sv.hkey[h];
  while (key != 0 && key != col + 1) {
    h = (h + 1u) & mask;
    key = sv.hkey[h];
  }
  return key == 0 ? -1 : sv.hid[h];
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

__device__ __forceinline__ void producer_sync(int nthreads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(PRODUCER_BAR), "r"(nthreads)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m > 0; m >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, m));
  return x;
}

// warp_sum's bits for lanes < K, where lanes >= K hold +0: a step whose
// partner lanes are all >= K (m >= K) adds +0 to every live lane, so those
// steps are one x + 0 (which still turns -0 into +0, as they do).
// KC: K when it is a compile-time constant (16, 32), else 0 (then K).
template <int KC>
__device__ __forceinline__ float warp_sum_live(float x, int K) {
  if (KC) {
    if (KC <= 16) x = __fadd_rn(x, 0.f);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      if (m < KC) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, m));
    return x;
  }
  int m = 16;
  if (K <= m) {
    x = __fadd_rn(x, 0.f);
    while (K <= m) m >>= 1;
  }
  for (; m > 0; m >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, m));
  return x;
}

// jnp.sign: -1, +1, and the argument itself for a signed zero or NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// Optional cycle accounting, a measurement hook (prof is null in the
// service): every lane of a warp adds clock64() deltas per stage of its
// loop (so the laps add no divergent branch), and the warp's writer lane
// stores the sums to prof[base ..] at the end.
struct Stopwatch {
  long long* out;
  bool writer;
  long long t, acc[8];
  __device__ Stopwatch(long long* o, bool w) : out(o), writer(w), t(0) {
    for (int i = 0; i < 8; ++i) acc[i] = 0;
    if (out) t = clock64();
  }
  // `dep`: a value the stage computed; the lap waits for it, so the stage
  // is charged for its latency and not the next one
  __device__ __forceinline__ void lap(int i, float dep = 0.f) {
    if (out) {
      unsigned sink;
      asm volatile("mov.b32 %0, %1;" : "=r"(sink) : "f"(dep));
      const long long now = clock64();
      acc[i] += now - t;
      t = now;
    }
  }
  __device__ void flush(int base, int n) {
    if (out && writer)
      for (int i = 0; i < n; ++i) out[base + i] = acc[i];
  }
};

// The P producer warps prepare every block, in block order.
__device__ __forceinline__ void produce(
    unsigned char* smem, const Plan& pl, uint64_t* full, uint64_t* released,
    const float* w, const int32_t* __restrict__ idx,
    const float* __restrict__ val, const float* __restrict__ tgt,
    const float* __restrict__ mask, int B, int K, int T, int S, int P,
    long long* prof) {
  const int NP = 32 * P;
  const int ptid = threadIdx.x - 64, pw = ptid >> 5, lane = ptid & 31;
  const int hsize = 1 << pl.hbits;
  const unsigned hmask = (unsigned)hsize - 1u;
  Stopwatch sw(pw == 0 ? prof : nullptr, ptid == 0);
  const int nblocks = (B + T - 1) / T;
  for (int n = 0; n < nblocks; ++n) {
    const int s = n % S;
    const unsigned u = (unsigned)(n / S);
    const int d0 = n * T;
    const int nd = B - d0 < T ? B - d0 : T;
    const int ne = nd * K;
    const long long base = (long long)d0 * K;
    // block n - S is written back and no block forwards from it
    mbar_wait(&released[s], (u & 1u) ^ 1u, BACKOFF_NS);
    sw.lap(0);
    const Slot sv = slot_at(smem, pl, s, T);

    // 1. stage the block's columns (into eid), values, targets and mask
    // with 4-byte cp.async, all in flight at once; an empty hash
    for (int e = ptid; e < ne; e += NP) {
      cp_async4(&sv.eid[e], idx + base + e);
      cp_async4(&sv.val[e], val + base + e);
    }
    for (int d = ptid; d < nd; d += NP) {
      cp_async4(&sv.meta[d].x, tgt + d0 + d);
      cp_async4(&sv.meta[d].y, mask + d0 + d);
    }
    for (int i = ptid; i < hsize; i += NP) sv.hkey[i] = 0;
    if (ptid == 0) {
      sv.hdr[0] = 0;
      sv.hdr[1] = 0;
      sv.hdr[2] = nd;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    producer_sync(NP);
    // 2. insert the columns (the winner of a key's CAS owns it: eid then
    // holds the hash position, negative for the owner)
    for (int e = ptid; e < ne; e += NP) {
      const int c = sv.eid[e];
      unsigned h = col_hash(c, pl.hbits);
      int owner = 0;
      for (;;) {
        const int old = atomicCAS(&sv.hkey[h], 0, c + 1);
        if (old == 0) {
          owner = 1;
          break;
        }
        if (old == c + 1) break;
        h = (h + 1u) & hmask;
      }
      sv.eid[e] = owner ? -1 - (int)h : (int)h;
    }
    producer_sync(NP);
    // 3. the owners number the distinct columns
    for (int e = ptid; e < ne; e += NP) {
      const int t = sv.eid[e];
      if (t < 0) {
        const int h = -1 - t;
        const int j = atomicAdd(&sv.hdr[0], 1);
        sv.hid[h] = j;
        sv.col[j] = sv.hkey[h] - 1;
      }
    }
    producer_sync(NP);
    sw.lap(1);
    // 4. each entry's table number; per distinct column the newest copy
    // in the older blocks in flight, and the gather
    for (int e = ptid; e < ne; e += NP) {
      const int t = sv.eid[e];
      sv.eid[e] = sv.hid[t < 0 ? -1 - t : t];
    }
    const int ndist = sv.hdr[0];
    for (int j = ptid; j < ndist; j += NP) {
      const int c = sv.col[j];
      cp_async4(&sv.tab[j], w + c);
      for (int dd = 1; dd < S && dd <= n; ++dd) {
        const int so = (n - dd) % S;
        const int jo = slot_find(slot_at(smem, pl, so, T), pl.hbits, c);
        if (jo >= 0) {
          const int f = atomicAdd(&sv.hdr[1], 1);
          sv.fdst[f] = j;
          sv.fsrc[f] = so * pl.NT + jo;
          break;
        }
      }
    }
    producer_sync(NP);
    sw.lap(2);
    // 5. per datum (one warp each): target, mask, |x|^2 in the consumer's
    // lane order and butterfly, and each 32-entry chunk's groups of equal
    // columns: the group's lowest lane (its leader) adds the group's
    // deltas in ascending k.  A member whose value is a zero with the
    // same bits as the member before it in the group is left out: its
    // delta is the same signed zero (or NaN) as the one before, and
    // (x + z) + z == x + z for such z, so the padding entries of a datum
    // cost one add, not K - live.
    for (int d = pw; d < nd; d += P) {
      const int e0 = d * K;
      float sq = 0.f;
      if (lane < K) {
        const float v = sv.val[e0 + lane];
        sq = __fmul_rn(v, v);
      }
      for (int k = lane + 32; k < K; k += 32) {
        const float v = sv.val[e0 + k];
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      sq = warp_sum(sq);
      unsigned adds = 0;
      for (int c0 = 0; c0 < K; c0 += 32) {
        const int k = c0 + lane;
        const bool live = k < K;
        const unsigned g =
            __match_any_sync(FULL, live ? sv.eid[e0 + k] : -1 - lane);
        const unsigned vb = live ? __float_as_uint(sv.val[e0 + k]) : 1u;
        const unsigned below = g & ((1u << lane) - 1u);
        const unsigned pv =
            __shfl_sync(FULL, vb, below ? 31 - __clz(below) : lane);
        const bool drop = below && (vb << 1) == 0u && pv == vb;
        const unsigned kept = g & ~__ballot_sync(FULL, drop);
        const bool leader = live && below == 0u;
        if (live) sv.grp[e0 + k] = leader ? kept : 0u;
        adds = max(adds, __reduce_max_sync(
                             FULL, leader ? __popc(kept) - 1u : 0u));
      }
      if (lane == 0) {
        sv.meta[d].z = sq;
        sv.meta[d].w = __uint_as_float(adds);
      }
    }
    sw.lap(3);
    cp_async_arrive(&full[s]);
    producer_sync(NP);                 // every shared store of the block
    if (ptid == 0) mbar_arrive(&full[s]);
    sw.lap(4);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  sw.flush(8, 5);
}

// Stores each finished block's distinct columns, in block order.
__device__ __forceinline__ void write_back(
    unsigned char* smem, const Plan& pl, uint64_t* done, uint64_t* released,
    float* w, int B, int T, int S, int lane, long long* prof) {
  Stopwatch sw(prof, lane == 0);
  const int nblocks = (B + T - 1) / T;
  for (int n = 0; n < nblocks; ++n) {
    const int s = n % S;
    mbar_wait(&done[s], (unsigned)(n / S) & 1u, BACKOFF_NS);
    sw.lap(0);
    const Slot sv = slot_at(smem, pl, s, T);
    const int ndist = sv.hdr[0];
    for (int j = lane; j < ndist; j += 32) w[sv.col[j]] = sv.tab[j];
    // these stores before any gather issued after released[s] completes
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&released[s]);
    sw.lap(1);
  }
  sw.flush(16, 2);
}

// The consumer, compiled for one method and, where K is 16 or 32 (KC), for
// that K: its per-datum chain then has no loop and no branch.
template <int METHOD, int KC>
__device__ __forceinline__ void consume(
    unsigned char* smem, const Plan& pl, uint64_t* full, uint64_t* done,
    uint64_t* released, int B, int Kr, int T, int S, float c, float eps,
    int lane, long long* prof) {
  const int K = KC ? KC : Kr;
  const float half_c = __fdiv_rn(0.5f, c);   // PA2's 0.5/c, once
  Stopwatch sw(prof, lane == 0);
  const int nblocks = (B + T - 1) / T;
  for (int n = 0; n < nblocks; ++n) {
    const int s = n % S;
    mbar_wait(&full[s], (unsigned)(n / S) & 1u);
    sw.lap(0);
    const Slot sv = slot_at(smem, pl, s, T);
    const int nd = sv.hdr[2];
    // 1. forwarding: the newest older copy of each column it has
    const int nfwd = sv.hdr[1];
    for (int f = lane; f < nfwd; f += 32) {
      const int src = sv.fsrc[f];
      const Slot so = slot_at(smem, pl, src / pl.NT, T);
      sv.tab[sv.fdst[f]] = so.tab[src % pl.NT];
    }
    __syncwarp();
    // no later block forwards from block n - S + 1
    if (lane == 0 && n - S + 1 >= 0) mbar_arrive(&released[(n + 1) % S]);
    sw.lap(1);

    // the first datum's entries and meta; later ones are loaded while the
    // datum before runs (they do not depend on the table).  Lanes >= K
    // read entry 0 and are masked, so the loop has no divergent branch.
    const bool live = lane < K;
    const int lk = live ? lane : 0;
    int t0 = sv.eid[lk];
    float v0 = sv.val[lk];
    unsigned m0 = sv.grp[lk];
    float4 meta = sv.meta[0];
    for (int d = 0; d < nd; ++d) {
      const int e0 = d * K;
      const int tc = t0;
      const float vc = v0;
      const unsigned mcg = live ? m0 : 0u;
      const float4 mc = meta;
      // 2. table reads and products (the table read issues first)
      const float g0 = sv.tab[tc];
      const int dn = d + 1 < nd ? d + 1 : d;
      t0 = sv.eid[dn * K + lk];
      v0 = sv.val[dn * K + lk];
      m0 = sv.grp[dn * K + lk];
      meta = sv.meta[dn];
      float pred = live ? __fmul_rn(g0, vc) : 0.f;
      for (int k = lane + 32; k < K; k += 32)
        pred = __fadd_rn(pred, __fmul_rn(sv.tab[sv.eid[e0 + k]],
                                         sv.val[e0 + k]));
      sw.lap(2, pred);
      pred = warp_sum_live<KC>(pred, K);
      sw.lap(3, pred);

      // 3. step size
      const float y = mc.x, mk = mc.y, sqn = mc.z;
      const float err = __fsub_rn(y, pred);
      const float loss = __fsub_rn(fabsf(err), eps);
      float tau;
      if (METHOD == PA) {
        tau = __fdiv_rn(loss, sqn);
      } else if (METHOD == PA1) {
        const float q = __fdiv_rn(loss, sqn);
        tau = q > c ? c : q;            // jnp.minimum: a NaN q stays NaN
      } else {
        tau = __fdiv_rn(loss, __fadd_rn(sqn, half_c));
      }
      if (!(mk > 0.f && loss > 0.f && sqn > 0.f)) tau = 0.f;
      const float coef = __fmul_rn(sign_of(err), tau);
      sw.lap(4, coef);

      // 4. scatter, chunk by chunk: each group's leader adds its own
      // delta and then its members' (shuffled) in ascending k, onto the
      // value the column had before this chunk
      const unsigned adds = __float_as_uint(mc.w);       // uniform
      for (int c0 = 0; c0 < K; c0 += 32) {
        int t = tc;
        float v = vc, base = g0;
        unsigned gm = mcg;
        if (c0 > 0) {                  // a later chunk (K > 32): uniform
          const bool kl = c0 + lane < K;
          const int e = e0 + (kl ? c0 + lane : c0);
          t = sv.eid[e];
          v = sv.val[e];
          gm = kl ? sv.grp[e] : 0u;
          base = sv.tab[t];            // what an earlier chunk stored
        }
        const float dl = __fmul_rn(coef, v);
        float acc = __fadd_rn(base, dl);
        unsigned rest = gm & (gm - 1u);
        for (unsigned i = 0; i < adds; ++i) {
          const float x =
              __shfl_sync(FULL, dl, rest ? __ffs(rest) - 1 : lane);
          acc = rest ? __fadd_rn(acc, x) : acc;
          rest &= rest - 1u;
        }
        if (gm) sv.tab[t] = acc;
        if (c0 + 32 < K) __syncwarp();
        sw.lap(5, acc);
      }
      // the table's stores before the next datum's reads
      __syncwarp();
      sw.lap(6);
    }
    if (lane == 0) mbar_arrive(&done[s]);   // releases the table
    sw.lap(7);
  }
  sw.flush(0, 8);
}

template <int METHOD, int KC>
__global__ void __launch_bounds__(32 * (2 + MAX_PRODUCERS))
regression_scan_kernel(float* w, const int32_t* __restrict__ idx,
                       const float* __restrict__ val,
                       const float* __restrict__ tgt,
                       const float* __restrict__ mask, int B, int K,
                       long long D, float c, float eps, int T, int S, int P,
                       long long* prof) {
  extern __shared__ __align__(16) unsigned char smem[];
  {
    // block r is replica r of a replica grid (0 in a one-block launch)
    const long long r = blockIdx.x;
    w += r * D;
    idx += r * B * K;
    val += r * B * K;
    tgt += r * B;
    mask += r * B;
    if (prof) prof += r * 24;
  }
  const Plan pl = make_plan(T, S, K);
  uint64_t* full = (uint64_t*)smem;
  uint64_t* done = full + S;
  uint64_t* released = done + S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32 * P + 1);  // each producer's cp.async arrival
                                        // + one release
      mbar_init(&done[i], 1);           // the consumer's lane 0
      mbar_init(&released[i], 2);       // writeback's and consumer's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 2) {
    produce(smem, pl, full, released, w, idx, val, tgt, mask, B, K, T, S, P,
            prof);
  } else if (warp == 1) {
    write_back(smem, pl, done, released, w, B, T, S, lane, prof);
  } else {
    consume<METHOD, KC>(smem, pl, full, done, released, B, K, T, S, c, eps,
                        lane, prof);
  }
}

template <int METHOD, int KC>
int launch(void* w, const void* indices, const void* values,
           const void* targets, const void* mask, int B, int K, long long D,
           int ndp, float c, float eps, int T, int S, int P, size_t smem,
           cudaStream_t stream, long long* prof) {
  auto kernel = regression_scan_kernel<METHOD, KC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<ndp, 32 * (2 + P), smem, stream>>>(
      (float*)w, (const int32_t*)indices, (const float*)values,
      (const float*)targets, (const float*)mask, B, K, D, c, eps, T, S, P,
      prof);
  return (int)cudaGetLastError();
}

template <int METHOD>
int launch_k(void* w, const void* indices, const void* values,
             const void* targets, const void* mask, int B, int K,
             long long D, int ndp, float c, float eps, int T, int S, int P,
             size_t smem, cudaStream_t stream, long long* prof) {
  if (K == 16)
    return launch<METHOD, 16>(w, indices, values, targets, mask, B, K, D,
                              ndp, c, eps, T, S, P, smem, stream, prof);
  if (K == 32)
    return launch<METHOD, 32>(w, indices, values, targets, mask, B, K, D,
                              ndp, c, eps, T, S, P, smem, stream, prof);
  return launch<METHOD, 0>(w, indices, values, targets, mask, B, K, D, ndp,
                           c, eps, T, S, P, smem, stream, prof);
}

}  // namespace

// Shared-memory bytes the kernel takes for a block of T datums, a ring of
// S slots and K entries a datum: what the wrapper's reg_scan_smem_bytes
// must agree with.
extern "C" long long regression_scan_smem_bytes(int T, int S, int K) {
  return (long long)make_plan(T, S, K).total;
}

// The replica grid with cycle accounting: prof (long long[24] a replica,
// zeroed by the caller) receives each block's consumer cycles in 0-7
// (wait for the block, forwarding, table reads and products, reduction,
// step, group adds and stores, __syncwarp, block commit), the first
// producer thread's in 8-12 (wait for a free slot, hash and numbering,
// lookups and gathers, per-datum |x|^2 and links, commit) and the
// writeback warp's in 16-17 (wait, stores).  B is the datums of ONE
// replica; ndp blocks run replica r on rows [r * B, (r + 1) * B) and on
// w[r * D ..].  A measurement hook: the service never passes prof.
extern "C" int regression_scan_grid_launch_profiled(
    void* w, const void* indices, const void* values, const void* targets,
    const void* mask, int B, int K, long long D, int ndp, int method,
    float c, float eps, int T, int S, int P, void* stream, void* prof) {
  if (B < 0 || K < 1 || method < PA || method > PA2 || T < 1 || S < 1 ||
      S > MAX_RING || P < 1 || P > MAX_PRODUCERS || ndp < 1 ||
      ndp > 65535 || D < 1 ||
      (long long)B * K + K >= (1LL << 30) || (long long)T * K > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_plan(T, S, K).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  long long* pr = (long long*)prof;
  if (method == PA)
    return launch_k<PA>(w, indices, values, targets, mask, B, K, D, ndp, c,
                        eps, T, S, P, smem, st, pr);
  if (method == PA1)
    return launch_k<PA1>(w, indices, values, targets, mask, B, K, D, ndp, c,
                         eps, T, S, P, smem, st, pr);
  return launch_k<PA2>(w, indices, values, targets, mask, B, K, D, ndp, c,
                       eps, T, S, P, smem, st, pr);
}

// The replica grid, the one C entry of the scan (a single-replica scan is
// the grid at ndp 1): every pointer and the stream as void*; method 0-2
// (PA, PA1, PA2); block T, ring S and producer warps P as the wrapper
// planned them; ndp blocks, block r replica r (B datums a replica, w
// stacked [ndp, D]).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int regression_scan_grid_launch(
    void* w, const void* indices, const void* values, const void* targets,
    const void* mask, int B, int K, long long D, int ndp, int method,
    float c, float eps, int T, int S, int P, void* stream) {
  return regression_scan_grid_launch_profiled(w, indices, values, targets,
                                              mask, B, K, D, ndp, method, c,
                                              eps, T, S, P, stream, nullptr);
}
