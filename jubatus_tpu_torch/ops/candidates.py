"""Bucketing and gather-rescore for the sublinear query path (counterpart
of jubatus_tpu/ops/candidates.py).

The row-store engines' full sweeps (ops/lsh.py: K3, K4) score every row
of the table.  Here a query scores only a CANDIDATE set that a coarse
index (jubatus_tpu_torch/index/) names:

  * signature methods (lsh, minhash, euclid_lsh): multi-probe bucketed
    signature bands.  A band of `bits` signature bits (a minhash slot
    folded to 2^bits buckets) keys a bucket; a query probes its own
    buckets plus 1-bit neighbours (band_plan) and only those buckets'
    rows are rescored;
  * exact methods (inverted_index, inverted_index_euclid): an IVF coarse
    quantizer.  Rows are count-sketch embedded into E dense coordinates
    and listed under their two nearest k-means centroids; a query probes
    its top `probes` centroids' lists.

The lists live on the device as CSR (flat row ids grouped by (band,
bucket), per-group offset and length, each group read `cap` slots wide)
plus an always-probed DELTA of rows indexed since the last pack
(index/store.py).  Every candidate is rescored with the full sweep's
exact math, so a returned row's score is bitwise the full sweep's; only
recall is approximate.  A row probed through several bands appears
several times: as in the JAX package the device keeps duplicates, widens
its top-k by the worst-case duplication (_kb) and the host dedupes the
short result (dedupe_topk).

The device top-kb follows jax.lax.top_k over the candidate VECTOR: ties
go to the lower candidate position, not the lower row.  A candidate's key
is K3's (ops/lsh.py scores_to_keys): the score's ordered bits in the high
word and 0xFFFFFFFF - position in the low word.

Two hand kernels in csrc/candidates.cu do a query's work on the card, one
wrapper call a read (K6 two launches, K7 four or five, on the caller's
stream), and their wrappers below launch them for CUDA tensors (raising
where they cannot) and run the plain PyTorch versions (the *_ref
functions) for CPU tensors:
  K6 sig_probe  <- _sig_probe_from_datum/_from_row/_batch: the probe
                   groups, the CSR gather with the delta, the signature
                   rescore (K3's count and cosine tables), the mask, the
                   top kb keys and the candidate count;
  K7 ivf_probe  <- _ivf_probe_query: the count-sketch embedding, the
                   centroid scores and their top `probes`, the gather of
                   both assignment bands with the delta, the gather-dot in
                   XLA's einsum order, the cosine or euclid tail, the
                   mask, the top kb keys and the candidate count.
Each returns int64 [Nq, 2 kb + 1]: the kb keys, the kb rows the keys'
positions name (-1 for an empty slot), then the candidate count (valid
candidates, duplicates counted, as JAX's jnp.sum(ok)).  One copy brings
it to the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.ops import lsh as lshops
from jubatus_tpu_torch.ops.lsh import (MASK32, SIG_KINDS, _check,
                                       _check_mask, _host, _round_k,
                                       keys_to_rows_scores, scores_to_keys,
                                       sig_width, similarities_ref)
from jubatus_tpu_torch.ops.sparse import fma as _fma
from jubatus_tpu_torch.ops.sparse import ftz, xla_dot_rows

# -- probe plans -------------------------------------------------------------
# A plan is a static tuple of (band, xor_mask) probes.  For bit-signature
# kinds each band is `bits` consecutive signature bits; probes beyond the
# band count re-probe earlier bands with a 1-bit flip.  For minhash each
# band is one slot and the bucket is the slot value folded into 2^bits
# buckets (no flips: slot values are hashes).


def n_bands_for(kind: str, hash_num: int, bits: int) -> int:
    if kind == "minhash":
        return hash_num
    return max(1, hash_num // bits)


def band_plan(kind: str, hash_num: int, bits: int, probes: int):
    """Static multi-probe plan: ((band, xor_mask), ...) of length
    <= probes (deduped; capped at the reachable bucket count)."""
    bands = n_bands_for(kind, hash_num, bits)
    plan, seen = [], set()
    p = 0
    while len(plan) < probes and p < probes * 4:
        band = p % bands
        wave = p // bands
        if kind == "minhash":
            mask = 0
            if wave > 0:        # no neighbor expansion for minhash
                break
        else:
            mask = 0 if wave == 0 else 1 << ((wave - 1) % bits)
        if (band, mask) not in seen:
            seen.add((band, mask))
            plan.append((band, mask))
        p += 1
    return tuple(plan)


def bucket_assign_np(kind: str, sigs: np.ndarray, n_bands: int,
                     bits: int) -> np.ndarray:
    """Host band assignment for index maintenance: sigs [N, W] uint32 ->
    [n_bands, N] int32 bucket values (no band offset)."""
    sigs = np.asarray(sigs, np.uint32)
    n = sigs.shape[0]
    out = np.zeros((n_bands, n), np.int32)
    if kind == "minhash":
        for b in range(n_bands):
            out[b] = (sigs[:, b] & np.uint32((1 << bits) - 1)).astype(np.int32)
        return out
    for b in range(n_bands):
        v = np.zeros((n,), np.uint32)
        for j in range(bits):
            pos = b * bits + j
            w, off = divmod(pos, 32)
            v |= ((sigs[:, w] >> np.uint32(off)) & np.uint32(1)) \
                << np.uint32(j)
        out[b] = v.astype(np.int32)
    return out


# -- count-sketch embedding (IVF coarse space) -------------------------------
# Each feature index is hashed to ONE of embed_dim coordinates with a +-1
# sign, so a row's embedding costs O(nnz) and centroid assignment is an
# [N, E] x [E, C] product.

_CS_H = np.uint32(0x9E3779B1)   # coordinate hash (odd multiplier)
_CS_S = np.uint32(0x85EBCA77)   # sign hash


def cs_embed_np(indices: np.ndarray, values: np.ndarray,
                embed_dim: int) -> np.ndarray:
    """[N, K] sparse rows -> [N, E] float32 count-sketch embeddings, the
    maintenance twin (float64 bincount, then float32; the query's own
    embedding is cs_embed_ref, float32 in XLA's scatter order)."""
    idx = np.asarray(indices).astype(np.uint32)
    h = ((idx * _CS_H) >> np.uint32(32 - int(np.log2(embed_dim)))) \
        .astype(np.int64)
    sign = 1.0 - 2.0 * ((idx * _CS_S) >> np.uint32(31)).astype(np.float32)
    n = idx.shape[0]
    flat = (np.arange(n, dtype=np.int64)[:, None] * embed_dim + h).ravel()
    w = (np.asarray(values, np.float32) * sign).ravel()
    return np.bincount(flat, weights=w, minlength=n * embed_dim) \
        .reshape(n, embed_dim).astype(np.float32)


# -- widths and the host dedupe ----------------------------------------------


def _cand_width(plan, cap: int, delta) -> int:
    return len(plan) * cap + (int(delta.shape[0]) if delta is not None else 0)


def _kb(k: int, plan, cap: int, delta) -> int:
    """Device top-k width: the requested k widened by the worst-case
    duplication factor (a row can surface once per probe + once via the
    delta); the host dedupes the short result back down to k."""
    return max(1, min(_round_k(max(int(k), 1)) * (len(plan) + 1),
                      _cand_width(plan, cap, delta)))


def _ivf_kb(k: int, probes: int, cap: int, delta) -> int:
    """ivf_probe_query's top-k width: rank-2 soft assignment lets a row
    surface via both its cells plus the delta (3x headroom)."""
    width = probes * 2 * cap \
        + (int(delta.shape[0]) if delta is not None else 0)
    return max(1, min(_round_k(max(int(k), 1)) * 3, width))


def dedupe_topk(rows: np.ndarray, scores: np.ndarray, k: int):
    """First-occurrence dedupe of a (rows, scores) top-k readback:
    duplicates carry identical (exact) scores, so keeping the first is
    order-preserving.  Stops at the first -inf (mask pad)."""
    out_r, out_s, seen = [], [], set()
    for r, s in zip(rows.tolist(), scores.tolist()):
        if not np.isfinite(s):
            break
        if r in seen:
            continue
        seen.add(r)
        out_r.append(r)
        out_s.append(s)
        if len(out_r) >= k:
            break
    return np.asarray(out_r, np.int64), np.asarray(out_s, np.float64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def probe_groups_ref(kind: str, q_sigs: torch.Tensor, plan,
                     bits: int) -> torch.Tensor:
    """[Nq, P] int64 group ids (band * 2^bits + bucket, each probe's xor
    applied) of query signatures q_sigs [Nq, W] (int32 bit patterns)."""
    q = q_sigs.to(torch.int64) & MASK32
    out = []
    for band, mask in plan:
        if kind == "minhash":
            v = q[:, band] & ((1 << bits) - 1)
        else:
            v = torch.zeros_like(q[:, 0])
            for j in range(bits):
                w, off = divmod(band * bits + j, 32)
                v = v | (((q[:, w] >> off) & 1) << j)
        out.append(band * (1 << bits) + (v ^ mask))
    return torch.stack(out, 1)


def gather_candidates_ref(flat: torch.Tensor, offsets: torch.Tensor,
                          lens: torch.Tensor, groups: torch.Tensor,
                          cap: int, delta: Optional[torch.Tensor]
                          ) -> torch.Tensor:
    """Each query's candidate vector [Nq, P * cap + Dcap] int64: every
    probed group's `cap` slots of flat from its offset (the start clamped
    as dynamic_slice clamps it), -1 past the group's length, then the
    delta's rows (-1 padded)."""
    nq = groups.shape[0]
    start = offsets.long()[groups].clamp(0, flat.shape[0] - cap)
    ar = torch.arange(cap, device=flat.device)
    c = flat.long()[start[..., None] + ar]
    c = torch.where(ar < lens.long()[groups][..., None], c,
                    torch.full_like(c, -1)).reshape(nq, -1)
    if delta is not None:
        c = torch.cat([c, delta.long()[None].expand(nq, -1)], 1)
    return c


def _valid_cands(cand: torch.Tensor, n_valid: int,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Candidates that name a row (>= 0) below n_valid that the mask
    keeps (_rescore_sig's keep & vmask)."""
    ok = (cand >= 0) & (cand < int(n_valid))
    if mask is not None:
        ok &= mask.to(torch.bool)[cand.clamp(0, mask.shape[0] - 1)]
    return ok


def _select(scores: torch.Tensor, ok: torch.Tensor, cand: torch.Tensor,
            kb: int) -> torch.Tensor:
    """[Nq, 2 kb + 1]: the top kb keys of the masked scores by candidate
    position, the rows they name, the count of valid candidates."""
    keys = scores_to_keys(torch.where(ok, scores, -math.inf))
    top = torch.topk(keys, kb, dim=1).values
    pos = MASK32 - (top & MASK32)
    return torch.cat([top, cand.gather(1, pos),
                      ok.sum(1, keepdim=True).to(torch.int64)], 1)


def sig_probe_ref(kind: str, table: torch.Tensor, norms: torch.Tensor,
                  n_valid: int, mask: Optional[torch.Tensor],
                  q_sigs: torch.Tensor, qnorms: torch.Tensor,
                  flat: torch.Tensor, offsets: torch.Tensor,
                  lens: torch.Tensor, delta: Optional[torch.Tensor],
                  cap: int, plan, bits: int, hash_num: int,
                  kb: int) -> torch.Tensor:
    """Plain version of K6 for query signatures q_sigs [Nq, W] with qnorms
    [Nq]: probe_groups_ref, gather_candidates_ref, each candidate's
    similarity with similarities_ref's math (the row read at its clamped
    id), the validity of _valid_cands, then _select."""
    groups = probe_groups_ref(kind, q_sigs, plan, bits)
    cand = gather_candidates_ref(flat, offsets, lens, groups, cap, delta)
    safe = cand.clamp(0, table.shape[0] - 1)
    scores = torch.stack([
        similarities_ref(kind, table[safe[q]], q_sigs[q], norms[safe[q]],
                         qnorms[q], hash_num)
        for q in range(cand.shape[0])]) if cand.shape[0] else \
        torch.empty(cand.shape, dtype=torch.float32)
    return _select(scores, _valid_cands(cand, n_valid, mask), cand, kb)


def cs_embed_ref(q_indices: torch.Tensor, q_values: torch.Tensor,
                 embed_dim: int) -> torch.Tensor:
    """One query's count-sketch embedding [E] float32 as XLA computes
    _cs_embed_traced: the signed values (inputs flushed) added one by one
    in k order into their coordinates from +0, each sum flushed (XLA's CPU
    scatter is a loop over the updates)."""
    idx = q_indices.to(torch.int64) & MASK32
    h = ((idx * int(_CS_H)) & MASK32) >> (32 - int(math.log2(embed_dim)))
    neg = (((idx * int(_CS_S)) & MASK32) >> 31) == 1
    v = ftz(q_values.float())
    u = torch.where(neg, -v, v)
    out = torch.zeros(embed_dim, dtype=torch.float32, device=v.device)
    for k in range(int(idx.shape[0])):
        out[h[k]] = ftz(out[h[k]] + u[k])
    return out


def gemv_rows_ref(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [C, E] @ v [E] as XLA's CPU row-major gemv computes it (read off
    its dump: row_major_gemv, tiles of 8 rows, 8-wide vectors): at E 8
    and up, 8 lanes a row, lane j a chain of fused multiply-adds over the
    columns k = j mod 8 in k order from +0, then ((l0 + l1) + (l2 + l3))
    + ((l4 + l5) + (l6 + l7)), then + 0; the rows past the last whole
    tile of 8 sum their lanes by halving, ((l0 + l4) + (l2 + l6)) + ((l1
    + l5) + (l3 + l7)).  Below E 8 (no whole vector of columns) every row
    is one chain of fused multiply-adds in k order from +0, then + 0.
    Every input and step flushed.  E a power of two, C at least 2 (the
    index trains 2 centroids at least; XLA turns a single row into a
    vector dot of another order)."""
    m = ftz(m.float())
    v = ftz(v.float())
    c, e = m.shape
    if e < 8:
        acc = torch.zeros(c, dtype=torch.float32, device=m.device)
        for k in range(e):
            acc = ftz(_fma(m[:, k], v[k].expand(c), acc))
        return acc + 0.0
    lanes = torch.zeros((c, 8), dtype=torch.float32, device=m.device)
    for k in range(0, e, 8):
        lanes = ftz(_fma(m[:, k:k + 8], v[None, k:k + 8].expand(c, 8),
                         lanes))
    p = ftz(lanes[:, 0::2] + lanes[:, 1::2])          # l01 l23 l45 l67
    q = ftz(p[:, 0::2] + p[:, 1::2])                  # l0123 l4567
    out = ftz(q[:, 0] + q[:, 1])
    # the rows past the last whole tile of 8: a halving tree instead
    t = 8 * (c // 8)
    h = ftz(lanes[t:, :4] + lanes[t:, 4:])            # l04 l15 l26 l37
    h = ftz(h[:, :2] + h[:, 2:])
    out[t:] = ftz(h[:, 0] + h[:, 1])
    return out + 0.0


def centroid_scores_ref(centroids: torch.Tensor,
                        e_q: torch.Tensor) -> torch.Tensor:
    """centroids @ e_q - 0.5 * sum(centroids ** 2, 1) [C] as XLA's CPU
    code computes it in _ivf_probe_query (E a power of two): the gemv
    (gemv_rows_ref), the squares' sum as XLA's reduce of that program
    orders it (_ssq_ref), then dot - 0.5 * sum.  At E 1 XLA folds the
    dot into the fusion as one product, so the score is one fused
    multiply-add, fma(c, e, -(0.5 * c * c)), the square rounded."""
    if centroids.shape[1] == 1:
        m = ftz(centroids.float()[:, 0])
        half = ftz(0.5 * ftz(m * m))
        return ftz(_fma(m, ftz(e_q.float()[0]).expand_as(m), -half))
    dot = gemv_rows_ref(centroids, e_q)
    return ftz(dot - ftz(0.5 * _ssq_ref(centroids)))


def ssq_vector_rows(c: int) -> int:
    """At E 8, the leading rows of [C, 8] whose squares' sum XLA's
    vectorized loop computes (rounded products added in k order from
    +0); the rows after them are its scalar loop's, a chain of fused
    multiply-adds from +0 (read off objdump -d of the fusion, and held
    row by row at C 1 to 4,111).  Below 16 rows LLVM vectorizes only a
    trip count that its vector width divides (2, 4, 8); from 16 the body
    takes 8 rows a step, and below 64 rows an epilogue of 4 rows takes 4
    more where at least 4 are left."""
    if c < 16:
        return c if c in (2, 4, 8) else 0
    n = 8 * (c // 8)
    if c < 64 and c % 8 >= 4:
        n += 4
    return n


def _ssq_ref(m: torch.Tensor) -> torch.Tensor:
    """sum(m * m, 1) in XLA's order for a row of E (read at E 2 to
    16,384; held up to 2^20): E 8 rounded products added in k order from
    +0 on the rows ssq_vector_rows names, a chain of fused multiply-adds
    from +0 on the others; E 2, 4, 16 and 32 a chain of fused
    multiply-adds from +0; E 64 and up jnp.sum's tree rewrite
    (ops.sparse.xla_dot_rows "sum": windows of 32 rounded products, each
    summed in k order from +0, the window sums windowed again while more
    than 32 are left, then summed in order)."""
    e = m.shape[1]
    if e >= 64:
        return xla_dot_rows(m, m, "sum")
    m = ftz(m.float())
    acc = torch.zeros(m.shape[0], dtype=torch.float32, device=m.device)
    for k in range(e):
        acc = ftz(_fma(m[:, k], m[:, k], acc))
    if e == 8:
        nv = ssq_vector_rows(m.shape[0])
        rnd = torch.zeros(nv, dtype=torch.float32, device=m.device)
        for k in range(e):
            rnd = ftz(rnd + ftz(m[:nv, k] * m[:nv, k]))
        acc[:nv] = rnd
    return acc


def ivf_probe_ref(metric: str, q_indices: torch.Tensor,
                  q_values: torch.Tensor, q_dense: torch.Tensor,
                  qnorm: torch.Tensor, centroids: torch.Tensor,
                  indices: torch.Tensor, values: torch.Tensor,
                  norms: torch.Tensor, n_valid: int,
                  mask: Optional[torch.Tensor], flat: torch.Tensor,
                  offsets: torch.Tensor, lens: torch.Tensor,
                  delta: Optional[torch.Tensor], cap: int, probes: int,
                  embed_dim: int, kb: int) -> torch.Tensor:
    """Plain version of K7 for one query (q_indices / q_values [K], its
    dense form q_dense [D], qnorm a 0-d float32): the embedding
    (cs_embed_ref), the centroid scores (centroid_scores_ref) and their
    top `probes` (ties: lower centroid), the groups of both assignment
    bands (top, then top + C), the gather with the delta, the einsum dot
    of each candidate row (ops.sparse.xla_dot_rows "einsum") and the
    metric's tail as K4's plain version computes it, then _select ->
    [1, 2 kb + 1]."""
    e_q = cs_embed_ref(q_indices, q_values, embed_dim)
    cs = centroid_scores_ref(centroids, e_q)
    top = torch.topk(scores_to_keys(cs), probes).values
    top_c = MASK32 - (top & MASK32)
    groups = torch.cat([top_c, top_c + centroids.shape[0]])[None]
    cand = gather_candidates_ref(flat, offsets, lens, groups, cap, delta)
    safe = cand[0].clamp(0, norms.shape[0] - 1)
    scores = _dense_tail(metric, xla_dot_rows(
        q_dense[indices[safe].long()], values[safe], "einsum"),
        norms[safe], qnorm)
    return _select(scores[None], _valid_cands(cand, n_valid, mask), cand,
                   kb)


def _dense_tail(metric: str, dots: torch.Tensor, n: torch.Tensor,
                qn: torch.Tensor) -> torch.Tensor:
    """_ivf_probe_query's score from a candidate's dot, as XLA computes
    it: cosine dots / max(n * qn, 1e-12); euclid -sqrt(max(fma(n, n,
    qn * qn) - 2 * dots, 0)) (ops.lsh.dense_scores_ref's tail)."""
    n = ftz(n)
    qn = ftz(qn)
    if metric == "cosine":
        return ftz(dots / torch.clamp_min(ftz(n * qn), 1e-12))
    a = ftz(_fma(n, n, ftz(qn * qn).expand_as(n)))
    return -lshops._sqrt(torch.clamp_min(ftz(a - 2.0 * dots), 0.0))


def probe_result(out: torch.Tensor, kb: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A K6/K7 result [Nq, 2 kb + 1] -> host (rows [Nq, kb] int64, scores
    [Nq, kb] float32, n_cand [Nq] int64), one copy."""
    h = out.cpu()
    _, scores = keys_to_rows_scores(h[:, :kb])
    return h[:, kb:2 * kb].numpy(), scores.numpy(), h[:, 2 * kb].numpy()


# ---------------------------------------------------------------------------
# the K6 and K7 wrappers
# ---------------------------------------------------------------------------

# csrc/candidates.cu's shapes, mirrored for the tests: candidate positions
# a stage-1 block; the chunks' lists that stage 2 holds in shared memory
# (keys); the pow2(kb) keys it sorts there; the widest embedding a
# centroid block builds in shared memory; the most probes K7 takes
PROBE_CHUNK = 1024
PROBE_LIST_SMEM_KEYS = 12288
PROBE_SORT_SMEM_KEYS = 4096
IVF_EMBED_SMEM_DIMS = 16384
IVF_MAX_PROBES = 8192
IVF_METRICS = ("cosine", "euclid")
# the count-sketch widths K7 takes: every power of two up to 2^30, whose
# XLA gemv and reduce order it reproduces.  IndexSpec accepts any power of
# two; above 2^30 a centroid's coordinates pass K7's 32-bit indices (8 GiB
# a centroid), and a recommender declines ivf at configure time with
# IVF_WIDE_REFUSAL: the JAX driver's own rebuild embeds its rows as a dense
# float64 [rows, E] (16 GiB a row there), which no host of it holds either
IVF_EMBED_DIMS = tuple(1 << b for b in range(0, 31))
IVF_WIDE_REFUSAL = ("an embed_dim above 2^30 passes K7's 32-bit coordinate "
                    "indices (8 GiB a centroid), and the JAX driver's "
                    "rebuild would take 16 GiB of float64 a row")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The candidates library, its entry points bound once."""
    return bind(build.load("candidates"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a candidates library's entry
    points (this checkout's, or a variant's built by build.load_variant)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sig_probe_launch.argtypes = (
        [p, p, ll, i, ll, p, p, p, p, i, p, ll, p, p, p, i, p, i, i, i, i,
         p, i, i, p, p, p])
    lib.sig_probe_launch.restype = i
    lib.ivf_probe_launch.argtypes = (
        [p, p, i, p, ctypes.c_float, p, i, i, i, p, p, p, ll, i, ll, p, p,
         ll, p, p, p, i, i, i, i, i, i, p, p, p])
    lib.ivf_probe_launch.restype = i
    lib.sig_probe_workspace_bytes.argtypes = [ll, i, i, i]
    lib.sig_probe_workspace_bytes.restype = ll
    lib.ivf_probe_workspace_bytes.argtypes = [ll, i, i, i, i]
    lib.ivf_probe_workspace_bytes.restype = ll
    return lib


@functools.lru_cache(maxsize=64)
def _plan_dev(plan, device: torch.device) -> torch.Tensor:
    """A probe plan as int32 [P, 2] (band, xor) on `device` (a copy that
    callers only read)."""
    return torch.tensor([list(bm) for bm in plan], dtype=torch.int32,
                        device=device).reshape(-1, 2)


def _csr_args(csr, dev, what: str):
    flat, offsets, lens, delta, cap = csr
    for t, name in ((flat, "flat"), (offsets, "offsets"), (lens, "lens")):
        _check(t, torch.int32, dev, f"{what} {name}")
    if delta is not None:
        _check(delta, torch.int32, dev, f"{what} delta")
    if offsets.shape != lens.shape or flat.shape[0] < int(cap) \
            or int(cap) <= 0:
        raise ValueError(f"{what}: a CSR of {flat.shape[0]} slots, "
                         f"{offsets.shape[0]} groups and cap {cap} does "
                         f"not fit")
    return flat, offsets, lens, delta, int(cap)


def _workspace(nbytes: int, dev) -> torch.Tensor:
    """A kernel's scratch in device memory, of the size its library
    reports (*_workspace_bytes)."""
    return torch.empty(int(nbytes), dtype=torch.uint8, device=dev)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def sig_probe(kind: str, table: torch.Tensor, norms: torch.Tensor,
              n_valid: int, mask: Optional[torch.Tensor], csr, plan,
              bits: int, hash_num: int, kb: int,
              q_sigs: Optional[torch.Tensor] = None,
              qnorms: Optional[torch.Tensor] = None,
              q_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each query's probe-and-rescore over the candidate index -> int64
    [Nq, 2 kb + 1] (module docstring): the table [R, W] int32 with norms
    [R], the rows below n_valid that the mask (bool or uint8 [R], None:
    every row) keeps valid; csr = (flat, offsets, lens, delta, cap) int32
    tensors on the table's device (index/base.py device_csr); the queries
    are signatures q_sigs [Nq, W] with qnorms [Nq], or stored rows q_rows
    [Nq] int64, each in [0, R) (the kernel reads their signatures and
    norms; the routes check the row on the host).  1 <= kb <=
    the candidate width.  CUDA tensors: K6 (csrc/candidates.cu, two
    launches); CPU: the plain version."""
    if kind not in SIG_KINDS:
        raise ValueError(f"unknown signature kind: {kind}")
    if (q_rows is None) == (q_sigs is None):
        raise ValueError("sig_probe: give q_sigs (with qnorms) or q_rows")
    r = table.shape[0]
    if not 0 <= int(n_valid) <= r:
        raise ValueError(f"sig_probe: {n_valid} valid rows of {r}")
    dev = table.device
    _check_mask(mask, r, dev, "sig_probe")
    flat, offsets, lens, delta, cap = _csr_args(csr, dev, "sig_probe")
    width = _cand_width(plan, cap, delta)
    if not 1 <= int(kb) <= width:
        raise ValueError(f"sig_probe: kb {kb} outside [1, {width}]")
    if dev.type == "cpu":
        if q_rows is not None:
            q_sigs, qnorms = table[q_rows], norms[q_rows]
        return sig_probe_ref(kind, table, norms, int(n_valid), mask, q_sigs,
                             qnorms, flat, offsets, lens, delta, cap, plan,
                             bits, hash_num, int(kb))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(table, torch.int32, dev, "sig_probe table")
    _check(norms, torch.float32, dev, "sig_probe norms")
    w = table.shape[1]
    if w != sig_width(kind, hash_num) or norms.shape != (r,):
        raise ValueError(f"sig_probe: table {tuple(table.shape)} / norms "
                         f"{tuple(norms.shape)} do not fit {kind} at "
                         f"hash_num {hash_num}")
    if q_rows is not None:
        _check(q_rows, torch.int64, dev, "sig_probe q_rows")
        nq = q_rows.shape[0]
    else:
        _check(q_sigs, torch.int32, dev, "sig_probe q_sigs")
        _check(qnorms, torch.float32, dev, "sig_probe qnorms")
        nq = q_sigs.shape[0]
        if q_sigs.shape != (nq, w) or qnorms.shape != (nq,):
            raise ValueError("sig_probe: query shapes do not fit the table")
    kb = int(kb)
    out = torch.empty((nq, 2 * kb + 1), dtype=torch.int64, device=dev)
    if nq == 0:
        return out
    lib = _lib()
    ws = _workspace(lib.sig_probe_workspace_bytes(width, len(plan), kb, nq),
                    dev)
    pl = _plan_dev(tuple(plan), dev)
    tab = lshops._count_table_dev(kind, hash_num, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sig_probe_launch(
        table.data_ptr(), norms.data_ptr(), r, w, int(n_valid), _ptr(mask),
        _ptr(q_sigs), _ptr(qnorms), _ptr(q_rows), nq, flat.data_ptr(),
        flat.shape[0], offsets.data_ptr(), lens.data_ptr(), _ptr(delta),
        0 if delta is None else delta.shape[0], pl.data_ptr(), len(plan),
        int(bits), cap, SIG_KINDS.index(kind), tab.data_ptr(), kb,
        _pow2(width), ws.data_ptr(), out.data_ptr(), stream)
    sig_probe.launches += 1
    build.check(err, "sig_probe launch")
    return out


sig_probe.launches = 0


def ivf_probe(metric: str, q_indices: torch.Tensor, q_values: torch.Tensor,
              q_dense: torch.Tensor, qnorm: float, centroids: torch.Tensor,
              indices: torch.Tensor, values: torch.Tensor,
              norms: torch.Tensor, n_valid: int,
              mask: Optional[torch.Tensor], csr, probes: int,
              embed_dim: int, kb: int) -> torch.Tensor:
    """One query's IVF probe-and-rescore -> int64 [1, 2 kb + 1]: its sparse
    form q_indices / q_values [K] (int32 / float32) for the count-sketch
    embedding, its dense form q_dense [D] and norm for the rescore; the
    centroids [C, E]; the row table (indices / values [R, Kr], norms [R])
    with the rows below n_valid that the mask keeps valid; csr as in
    sig_probe, two bands of C groups.  1 <= probes <= min(C,
    IVF_MAX_PROBES), E = embed_dim a power of two in IVF_EMBED_DIMS.
    CUDA tensors: K7 (csrc/candidates.cu, four launches, five above
    IVF_EMBED_SMEM_DIMS); CPU: the plain version."""
    if metric not in IVF_METRICS:
        raise ValueError(f"unknown ivf metric {metric!r}")
    c, e = centroids.shape
    if e != int(embed_dim) or e not in IVF_EMBED_DIMS:
        raise ValueError(f"ivf_probe: centroids [{c}, {e}] at embed_dim "
                         f"{embed_dim}: E must be a power of two from 1 to "
                         f"{IVF_EMBED_DIMS[-1]}: {IVF_WIDE_REFUSAL}")
    if not 1 <= int(probes) <= min(c, IVF_MAX_PROBES):
        raise ValueError(f"ivf_probe: {probes} probes of {c} centroids")
    r = norms.shape[0]
    if not 0 <= int(n_valid) <= r:
        raise ValueError(f"ivf_probe: {n_valid} valid rows of {r}")
    dev = indices.device
    _check_mask(mask, r, dev, "ivf_probe")
    flat, offsets, lens, delta, cap = _csr_args(csr, dev, "ivf_probe")
    width = 2 * int(probes) * cap + (0 if delta is None else delta.shape[0])
    if not 1 <= int(kb) <= width:
        raise ValueError(f"ivf_probe: kb {kb} outside [1, {width}]")
    if dev.type == "cpu":
        qn = torch.tensor(np.float32(qnorm))
        return ivf_probe_ref(metric, q_indices, q_values, q_dense, qn,
                             centroids, indices, values, norms, int(n_valid),
                             mask, flat, offsets, lens, delta, cap,
                             int(probes), e, int(kb))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(q_indices, torch.int32, dev, "ivf_probe q_indices")
    _check(q_values, torch.float32, dev, "ivf_probe q_values")
    _check(q_dense, torch.float32, dev, "ivf_probe q_dense")
    _check(centroids, torch.float32, dev, "ivf_probe centroids")
    _check(indices, torch.int32, dev, "ivf_probe indices")
    _check(values, torch.float32, dev, "ivf_probe values")
    _check(norms, torch.float32, dev, "ivf_probe norms")
    if (q_indices.dim() != 1 or q_values.shape != q_indices.shape
            or indices.dim() != 2 or values.shape != indices.shape
            or indices.shape[0] != r or q_indices.shape[0] == 0):
        raise ValueError("ivf_probe: query or table shapes do not fit")
    kb = int(kb)
    out = torch.empty((1, 2 * kb + 1), dtype=torch.int64, device=dev)
    lib = _lib()
    ws = _workspace(lib.ivf_probe_workspace_bytes(width, int(probes), kb, c,
                                                  e), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ivf_probe_launch(
        q_indices.data_ptr(), q_values.data_ptr(), q_indices.shape[0],
        q_dense.data_ptr(), float(np.float32(qnorm)), centroids.data_ptr(),
        c, e, int(probes), indices.data_ptr(), values.data_ptr(),
        norms.data_ptr(), r, indices.shape[1], int(n_valid), _ptr(mask),
        flat.data_ptr(), flat.shape[0], offsets.data_ptr(), lens.data_ptr(),
        _ptr(delta), 0 if delta is None else delta.shape[0], cap,
        IVF_METRICS.index(metric), kb, _pow2(width), _pow2(c), ws.data_ptr(),
        out.data_ptr(), stream)
    ivf_probe.launches += 1
    build.check(err, "ivf_probe launch")
    return out


ivf_probe.launches = 0


# ---------------------------------------------------------------------------
# the query routes (ops/candidates.py sig_probe_query*, ivf_probe_query)
# ---------------------------------------------------------------------------

def _deduped(out: torch.Tensor, kb: int, k: int):
    rows, scores, n = probe_result(out, kb)
    pairs = [dedupe_topk(rows[i], scores[i], int(k))
             for i in range(rows.shape[0])]
    return [p[0] for p in pairs], [p[1] for p in pairs], n


def sig_probe_query_batch(kind: str, key, q_indices: np.ndarray,
                          q_values: np.ndarray, table: torch.Tensor,
                          qnorms, norms: torch.Tensor, n_valid: int,
                          mask: Optional[torch.Tensor], csr, hash_num: int,
                          k: int, plan, bits: int,
                          padded_b: Optional[int] = None):
    """[Nq] datum queries through the index: signatures (K1/K2, signed as
    in a batch of padded_b), then one K6 call -> (rows_list,
    scores_list, n_cand [Nq]), each query's rows and scores deduped to k
    (ragged lists)."""
    dev = table.device
    kb = _kb(k, plan, csr[4], csr[3])
    q_sigs = lshops.signature(key, _host(q_indices, np.int32, dev),
                              _host(q_values, np.float32, dev), hash_num,
                              kind, padded_b)
    out = sig_probe(kind, table, norms, n_valid, mask, csr, plan, bits,
                    hash_num, kb, q_sigs=q_sigs,
                    qnorms=_host(qnorms, np.float32, dev))
    return _deduped(out, kb, k)


def sig_probe_query(kind: str, key, q_indices, q_values, table, qnorm: float,
                    norms, n_valid: int, mask, csr, hash_num: int, k: int,
                    plan, bits: int):
    """One datum query -> (rows, scores, n_cand): K1/K2 at B 1, then
    K6."""
    rows, scores, n = sig_probe_query_batch(
        kind, key, q_indices, q_values, table, [qnorm], norms, n_valid,
        mask, csr, hash_num, k, plan, bits)
    return rows[0], scores[0], int(n[0])


def sig_probe_query_sig(kind: str, table: torch.Tensor, q_sig, qnorm: float,
                        norms, n_valid: int, mask, csr, hash_num: int,
                        k: int, plan, bits: int):
    """Query by a raw signature (the partition plane's from_id legs) ->
    (rows, scores, n_cand): one K6 call with q_sigs [1, W] and qnorms
    [1]."""
    kb = _kb(k, plan, csr[4], csr[3])
    q_sigs, qnorms = lshops.sig_query_args(q_sig, qnorm, table.device)
    out = sig_probe(kind, table, norms, n_valid, mask, csr, plan, bits,
                    hash_num, kb, q_sigs=q_sigs, qnorms=qnorms)
    rows, scores, n = _deduped(out, kb, k)
    return rows[0], scores[0], int(n[0])


def sig_probe_query_row(kind: str, table: torch.Tensor, row: int, norms,
                        n_valid: int, mask, csr, hash_num: int, k: int, plan,
                        bits: int):
    """Query by a stored row -> (rows, scores, n_cand): one K6 call,
    which reads the row's signature and norm on the device."""
    if not 0 <= int(row) < table.shape[0]:
        raise IndexError(f"row {row} outside the table's {table.shape[0]}")
    kb = _kb(k, plan, csr[4], csr[3])
    out = sig_probe(kind, table, norms, n_valid, mask, csr, plan, bits,
                    hash_num, kb, q_rows=torch.tensor(
                        [int(row)], dtype=torch.int64, device=table.device))
    rows, scores, n = _deduped(out, kb, k)
    return rows[0], scores[0], int(n[0])


def ivf_probe_query(metric: str, q_indices: np.ndarray,
                    q_values: np.ndarray, q_dense: np.ndarray, qnorm: float,
                    centroids: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, norms: torch.Tensor, n_valid: int,
                    mask, csr, k: int, probes: int, embed_dim: int):
    """One query (its sparse batch row [K] and dense form [D], host
    arrays) through the IVF index -> (rows, scores, n_cand): one K7
    call."""
    dev = indices.device
    probes = max(1, min(int(probes), int(centroids.shape[0])))
    kb = _ivf_kb(k, probes, csr[4], csr[3])
    out = ivf_probe(
        metric, _host(np.asarray(q_indices).reshape(-1), np.int32, dev),
        _host(np.asarray(q_values).reshape(-1), np.float32, dev),
        _host(q_dense, np.float32, dev), qnorm, centroids, indices, values,
        norms, n_valid, mask, csr, probes, embed_dim, kb)
    rows, scores, n = _deduped(out, kb, k)
    return rows[0], scores[0], int(n[0])
