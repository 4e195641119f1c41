"""Locality-sensitive hashing over hashed sparse batches (counterpart of
jubatus_tpu/ops/lsh.py).

Signatures are part of the model: rows written by one server are compared
with queries signed by another, and model files, MIX diffs and journals
move between this package and the JAX one.  So the random numbers and
the signatures are jax's own, bit for bit as XLA's CPU code computes
them: threefry2x32 (jax_threefry_partitionable), fold_in, jax's uniform
and normal transforms, XLA's float32 log1p and log (xla_log1p, xla_log)
and erf_inv, and the projection's sum in XLA's order (project), each
multiply fused into its add where XLA's compiled code fuses it, with
denormals flushed as XLA flushes them.  XLA's order depends on the batch
it signs, and the JAX driver pads some routes' batches: the signing
functions take that batch's size (padded_b).

  * lsh / euclid_lsh: signed random projections.  Feature i's hyperplane
    row is normal(fold_in(key, i), (H,)); a datum's signature packs
    (sum_k v_k * row(i_k) >= 0) into ceil(H/32) uint32 words.
  * minhash: weighted minhash.  Slot h keeps the feature index i_k that
    minimises -log(u_{i_k,h}) / |v_k|, u = uniform(fold_in(key, i),
    (H,), 1e-12, 1), the first k winning ties.

A table sweep scores one or many query signatures against every row
(lsh: 1 - hamming/H; minhash: equal slots/H; euclid_lsh: minus the
LSH-estimated distance) and keeps each query's top kb rows as unique,
order-preserving int64 keys: the score's order-preserving image in the
high word and 0xFFFFFFFF - row in the low word, so the keys' order is
jax.lax.top_k's, ties to the lower row included.

A sweep's valid rows are those below a count (the nearest_neighbor
store, a prefix) that an optional bool mask keeps (the recommender's
store, with holes); the others score -inf and fill in as jax.lax.top_k
places them.  The row engines' exact sweeps score a dense query against
a sparse row table (indices / values [R, Kr]) in XLA's CPU order of
their JAX expressions (ops/sparse.py xla_dot_rows), and anomaly's
signature sweeps count every (query, row) pair.

Five hand kernels in csrc/lsh.cu do the work on the card (K1
lsh_signature, K2 minhash_signature, K3 sig_topk: the sweep with its
top-kb selection, so only [Nq, kb] keys leave the card; K4 dense_topk
and dense_dots: the exact sweep with its masked top-kb, or its [C, R]
dots; K5 sig_counts: the counts or euclid estimates of every pair);
each wrapper below launches its kernel for a CUDA tensor, raising where
it cannot, and runs the plain PyTorch version (the *_ref functions) for
a CPU tensor.
Signature tables are int32 tensors holding the uint32 bit patterns
(torch's uint32 has few CPU ops); host arrays stay uint32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.ops.sparse import fma as _fma
from jubatus_tpu_torch.ops.sparse import ftz

MASK32 = 0xFFFFFFFF
SIG_KINDS = ("lsh", "minhash", "euclid_lsh")

# threefry2x32's key-schedule parity constant and rotations (Salmon et
# al.; jax/_src/prng.py _threefry2x32_lowering)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erf_inv (Giles' polynomials, in the order XLA evaluates
# them): w = -log1p(-x^2); w < 5: p(w - 2.5), else p(sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# jax.random.normal's uniform range: [nextafter(-1, 0), 1)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_MINHASH_LO = float(np.float32(1e-12))


def words_for(hash_num: int) -> int:
    return (hash_num + 31) // 32


def sig_width(kind: str, hash_num: int) -> int:
    """Words per row in a signature table of the given kind."""
    return hash_num if kind == "minhash" else words_for(hash_num)


# ---------------------------------------------------------------------------
# jax's threefry, in int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def prng_key(seed: int) -> Tuple[int, int]:
    """The two uint32 words of jax.random.key(seed) (threefry_seed with
    64-bit integers off: the seed is a 32-bit integer, so its high word
    is 0 and its low word is its two's-complement bit pattern)."""
    return 0, int(seed) & MASK32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax's threefry2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2): twenty rounds, a key injection after every four.  Arguments
    are int64 tensors (or ints) holding uint32 values; so is the
    result."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def fold_in(key: Tuple[int, int], data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.random.fold_in(key, data) for an int tensor of data: the key
    words threefry2x32(key, (0, uint32(data)))."""
    d = data.to(torch.int64) & MASK32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) for a tensor of keys [...]: [..., n]
    int64 holding uint32, hi ^ lo of threefry2x32(key, (0, h))."""
    h = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(h), h)
    return y1 ^ y2


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float
                      ) -> torch.Tensor:
    """jax's _uniform as XLA computes it: the top 23 bits as the mantissa
    of [1, 2), minus 1, scaled into [minval, maxval) in float32, floored
    at minval.  XLA's simplifier drops a scale of 1 and then folds the two
    constants of (f - 1) + minval into one, f32(minval - 1): so minhash's
    uniform is max(1e-12, f - 1) exactly, with no 1e-12 added."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    if scale == 1.0:
        u = f + float(np.float32(-1.0) + lo)
    else:
        u = _fma(f - 1.0, torch.full_like(f, float(scale)), float(lo))
    return torch.maximum(torch.tensor(float(lo), dtype=torch.float32,
                                      device=bits.device), u)


# ---------------------------------------------------------------------------
# XLA's CPU float32 arithmetic
# ---------------------------------------------------------------------------
#
# XLA's CPU backend runs its code with denormals flushed (inputs read as
# zero, results written as zero: DAZ and FTZ, ops.sparse.ftz here) and
# lets LLVM contract a multiply and the add that takes its result into one
# fused multiply-add wherever the multiply has no other use
# (FPOpFusion::Fast, on a host with FMA).  The functions below repeat the
# instructions of XLA's compiled code (read from its dumped object files,
# --xla_dump_to), fused where it is fused.

MIN_NORMAL = float(np.float32(2.0 ** -126))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of x >= 0, as vsqrtps gives it
    (torch's vectorized CPU sqrt may miss by an ulp): the float64 root
    rounded to float32, then moved by an ulp where x lies beyond a
    neighbour's midpoint (squares of 25-bit midpoints are exact in
    float64)."""
    xd = x.double()
    s = torch.sqrt(xd).float()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    dn = torch.nextafter(s, torch.zeros_like(s))
    mid_up = (s.double() + up.double()) * 0.5
    mid_dn = (s.double() + dn.double()) * 0.5
    s = torch.where(xd > mid_up * mid_up, up, s)
    return torch.where(xd < mid_dn * mid_dn, dn, s)


def _bits_f32(b: int) -> float:
    return float(np.array(b, np.uint32).view(np.float32))


# XLA's float32 log (Cephes' logf): a range reduction on the exponent
# bits, then x + x^2 (-1/2 + x P(x)) in three interleaved chains
_LOG_C = tuple(_bits_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC, 0xBE7FFFFC,
    0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA))
_LOG_Q1 = _bits_f32(0xB95E8083)          # log(2) = Q2 + Q1
_LOG_Q2 = _bits_f32(0x3F318000)
_SQRTHF = _bits_f32(0x3F3504F3)
# XLA's log1p below |x| < sqrt(2) - 1: x + (-x^2/2 + x^3 Q(x) / P(x))
_LOG1P_THRESH = _bits_f32(0x3ED413CD)
_LOG1P_P = tuple(_bits_f32(b) for b in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
    0x42707982))
_LOG1P_Q = tuple(_bits_f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101))
_NAN_BITS = -1                           # 0xFFFFFFFF
_NEG_INF_BITS = -0x800000                # 0xFF800000
_INF_BITS = 0x7F800000


def _log_core(a: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of a (whose subnormals the caller has read as
    zero), special cases included: log(+-0) = -inf, log(+inf) = +inf,
    log(<0 or NaN) = 0xFFFFFFFF."""
    le0 = ~(a > 0)
    eq0 = a == 0
    inf = a == math.inf
    m0 = torch.where(a > MIN_NORMAL, a, MIN_NORMAL)
    bits = m0.view(torch.int32)
    e = bits >> 23
    mant = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    t = (e - 127).float() + 1.0
    lt = mant < _SQRTHF
    xr = (mant - 1.0) + torch.where(lt, mant, 0.0)
    t = torch.where(lt, t - 1.0, t)
    z = xr * xr
    z3 = z * xr
    c = _LOG_C
    a1 = _fma(xr, _fma(xr, torch.full_like(xr, c[0]), c[1]), c[6])
    a2 = _fma(xr, _fma(xr, torch.full_like(xr, c[2]), c[3]), c[7])
    a3 = _fma(xr, _fma(xr, torch.full_like(xr, c[4]), c[5]), c[8])
    s = _fma(z3, _fma(z3, a1, a2), a3)
    s = _fma(z3, s, t * _LOG_Q1)
    r = _fma(z, torch.full_like(z, -0.5), xr) + s
    r = _fma(t, torch.full_like(t, _LOG_Q2), r)
    out = torch.where(le0, _NAN_BITS, r.view(torch.int32))
    out = torch.where(inf, _INF_BITS, out)
    out = torch.where(eq0, _NEG_INF_BITS, out)
    return out.view(torch.float32)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """jnp.log of a float32 tensor, bit for bit as XLA's CPU code
    computes it."""
    return _log_core(ftz(x))


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """jnp.log1p of a float32 tensor, bit for bit as XLA's CPU code
    computes it: the rational below |x| < sqrt(2) - 1, else log(1 + x)."""
    x = ftz(x)
    big = _log_core(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    p = zero + 1.0
    for c in _LOG1P_P:
        p = _fma(x, p, c)
    q = zero + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = _fma(x, q, c)
    small = x + _fma(x2, torch.full_like(x2, -0.5), (x * x2) * (q / p))
    return torch.where(x.abs() < _LOG1P_THRESH, small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv, operation by operation, each step c + p * w
    of the polynomial fused as XLA's CPU code fuses it."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(torch.float32))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's float32 draw from its random bits."""
    return erf_inv(uniform_from_bits(bits, _NORMAL_LO, 1.0)) * _SQRT2


# ---------------------------------------------------------------------------
# signatures: plain versions and the K1 / K2 wrappers
# ---------------------------------------------------------------------------

def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits [B, H] bool -> [B, ceil(H/32)] int32 (uint32 patterns), bit j
    of word w is hash 32w + j, the tail bits 0."""
    b, h = bits.shape
    w = words_for(h)
    padded = torch.zeros((b, w * 32), dtype=torch.int64, device=bits.device)
    padded[:, :h] = bits.to(torch.int64)
    powers = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = (padded.view(b, w, 32) * powers).sum(-1)
    return _to_i32(words)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# K1's summation orders (csrc/lsh.cu ORDER_*)
ORDER_K, ORDER_LANES16, ORDER_LANES = 0, 1, 2


def projection_order(b: int, k: int) -> int:
    """XLA's summation order for the projection of a [b, k] batch, b the
    batch XLA signs (the JAX driver pads some routes' batches: their
    callers pass padded_b).  At one datum whose width is a multiple of 16
    the einsum is a dot fused with the normals and LLVM vectorizes its sum
    over k: eight lanes (ORDER_LANES16 at K 16, ORDER_LANES above); every
    other shape goes to XLA's column-major gemv, in k order (ORDER_K).
    Every width the converter pads to (16, 32, 64, ...) is such a
    multiple; at one datum of another width XLA's order is its own
    (ROADMAP Queue 3), and this one is k order."""
    if b != 1 or k < 16 or k % 16:
        return ORDER_K
    return ORDER_LANES16 if k == 16 else ORDER_LANES


def project(normal_of, values: torch.Tensor, order: int) -> torch.Tensor:
    """einsum("bkh,bk->bh") of the normals ([B, H] of feature k:
    normal_of(k)) and [B, K] values (read with DAZ) in XLA's order, each
    step a fused multiply-add from +0 and each result flushed as XLA's
    CPU code flushes it:
      * ORDER_K: one chain in k order;
      * ORDER_LANES: lane j < 8 keeps two chains, A over k = j, j+16, ...
        and B over k = j+8, j+24, ...; S_j = B_j + A_j;
      * ORDER_LANES16: lane j's one chain over k = j, j+8 (XLA fuses B's
        one product into the sum: S_j = fma(n_{j+8}, v_{j+8}, A_j));
    then S_j + S_{j+4}, then + the pair two apart, then the last two."""
    b, k = values.shape
    v = ftz(values)
    if order == ORDER_K:
        acc = None
        for j in range(k):
            n = normal_of(j)
            acc = ftz(_fma(n, v[:, j:j + 1].expand_as(n),
                           torch.zeros_like(n) if acc is None else acc))
        return acc
    normals = torch.stack([normal_of(j) for j in range(k)], 1)
    h = normals.shape[-1]
    lanes = 8 if order == ORDER_LANES16 else 16
    n = normals.reshape(b, k // lanes, lanes, h)
    vv = v.reshape(b, k // lanes, lanes, 1).expand(b, k // lanes, lanes, h)
    s = torch.zeros((b, lanes, h), dtype=torch.float32,
                    device=normals.device)
    for i in range(k // lanes):
        s = ftz(_fma(n[:, i], vv[:, i], s))
    if order == ORDER_LANES:
        s = ftz(s[:, 8:] + s[:, :8])
    s = ftz(s[:, :4] + s[:, 4:])
    s = ftz(s[:, :2] + s[:, 2:])
    return ftz(s[:, 0] + s[:, 1])


def feature_normals(key, indices: torch.Tensor, hash_num: int):
    """normal_of(k) for project: feature k's hyperplane rows [B, H],
    normal(fold_in(key, i_k), (H,))."""
    def normal_of(j: int) -> torch.Tensor:
        f1, f2 = fold_in(key, indices[:, j])
        return normal_from_bits(random_bits(f1, f2, hash_num))
    return normal_of


def lsh_signature_ref(key, indices: torch.Tensor, values: torch.Tensor,
                      hash_num: int, padded_b: Optional[int] = None
                      ) -> torch.Tensor:
    """Plain version of K1: [B, K] -> [B, ceil(H/32)] int32, the
    projection summed in XLA's order for a batch of padded_b (default B)
    datums (project)."""
    b, k = indices.shape
    if k == 0:
        return _pack_bits(torch.ones((b, hash_num), dtype=torch.bool,
                                     device=indices.device))
    proj = project(feature_normals(key, indices, hash_num), values,
                   projection_order(padded_b or b, k))
    return _pack_bits(proj >= 0)


def minhash_signature_ref(key, indices: torch.Tensor, values: torch.Tensor,
                          hash_num: int) -> torch.Tensor:
    """Plain version of K2: [B, K] -> [B, H] int32 (uint32 feature
    indices), the first k winning ties, slot 0 where every value is 0
    (values read with DAZ, as XLA reads them)."""
    b, k = indices.shape
    best_e = None
    best_k = torch.zeros((b, hash_num), dtype=torch.int64,
                         device=indices.device)
    w_all = ftz(values).abs()
    for j in range(k):
        f1, f2 = fold_in(key, indices[:, j])
        u = uniform_from_bits(random_bits(f1, f2, hash_num), _MINHASH_LO,
                              1.0)
        w = w_all[:, j:j + 1]
        e = torch.where(w > 0, ftz(-xla_log(u) / torch.clamp_min(
            w, _MINHASH_LO)), math.inf)
        if best_e is None:
            best_e = e
            continue
        better = e < best_e
        best_e = torch.where(better, e, best_e)
        best_k = torch.where(better, j, best_k)
    return torch.gather(indices.to(torch.int32), 1, best_k)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The LSH library, its entry points bound once."""
    lib = build.load("lsh")
    # (idx, val, out, k0, k1, B, K, H[, K1's order], stream)
    for fn, ints in ((lib.lsh_signature_launch, 4),
                     (lib.minhash_signature_launch, 3)):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_uint32] * 2
                       + [ctypes.c_int] * ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.sig_topk_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
    # K4: (indices, values, norms, count, mask, q_dense, qnorms, R, Kr, D,
    # NQ, metric, KB, ws, ws_bytes, out, stream)
    lib.dense_topk_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
    lib.dense_topk_launch.restype = ctypes.c_int
    lib.dense_topk_workspace.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_longlong])
    lib.dense_topk_workspace.restype = ctypes.c_longlong
    # (indices, values, q_dense, R, Kr, D, C, out, stream)
    lib.dense_dots_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2)
    lib.dense_dots_launch.restype = ctypes.c_int
    # K5 and its scores mode: (table, q_sigs, norms, qnorms, tab, R, W,
    # NQ, kind, out, stream); its plan (R, W, NQ, kind, table,
    # out int32[13])
    for fn in (lib.sig_counts_launch, lib.sig_scores_launch):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    lib.sig_counts_plan.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    lib.sig_counts_plan.restype = ctypes.c_int
    lib.sig_topk_launch.restype = ctypes.c_int
    lib.sig_topk_workspace.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_longlong]
        + [ctypes.c_int])
    lib.sig_topk_workspace.restype = ctypes.c_longlong
    lib.sig_topk_plan.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_longlong]
        + [ctypes.c_int, ctypes.c_void_p])
    lib.sig_topk_plan.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, dtype, dev, what: str) -> None:
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")


def _signature_launch(wrapper, key, indices, values, hash_num: int,
                      width: int, padded_b: Optional[int] = None
                      ) -> torch.Tensor:
    """One launch of the kernel of `wrapper` (lsh_signature or
    minhash_signature), counted on it; K1 takes its summation order."""
    fn_name = wrapper.__name__
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(indices, torch.int32, dev, fn_name)
    _check(values, torch.float32, dev, fn_name)
    if indices.dim() != 2 or values.shape != indices.shape:
        raise ValueError(f"{fn_name}: indices {tuple(indices.shape)} and "
                         f"values {tuple(values.shape)} differ")
    if hash_num <= 0:
        raise ValueError("hash_num must be > 0")
    b, k = indices.shape
    out = torch.empty((b, width), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    if k == 0:
        raise ValueError(f"{fn_name}: a batch of width 0")
    order = ((projection_order(padded_b or b, k),)
             if wrapper is lsh_signature else ())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_lib(), f"{fn_name}_launch")(
        indices.data_ptr(), values.data_ptr(), out.data_ptr(),
        key[0] & MASK32, key[1] & MASK32, b, k, hash_num, *order, stream)
    wrapper.launches += 1
    build.check(err, f"{fn_name} launch")
    return out


def lsh_signature(key, indices: torch.Tensor, values: torch.Tensor,
                  hash_num: int, padded_b: Optional[int] = None
                  ) -> torch.Tensor:
    """Signed-random-projection signatures: [B, K] int32 indices and
    float32 values -> [B, ceil(H/32)] int32 (uint32 patterns), as the JAX
    package signs them in a batch of padded_b datums (default B: XLA's
    summation order depends on it, projection_order).  CUDA tensors: one
    launch of K1 (csrc/lsh.cu); CPU: the plain version."""
    if indices.device.type == "cpu":
        return lsh_signature_ref(key, indices, values, hash_num, padded_b)
    return _signature_launch(lsh_signature, key, indices, values, hash_num,
                             words_for(hash_num), padded_b)


lsh_signature.launches = 0


def minhash_signature(key, indices: torch.Tensor, values: torch.Tensor,
                      hash_num: int) -> torch.Tensor:
    """Weighted minhash: [B, K] -> [B, H] int32 (uint32 feature indices).
    CUDA tensors: one launch of K2 (csrc/lsh.cu); CPU: the plain
    version."""
    if indices.device.type == "cpu":
        return minhash_signature_ref(key, indices, values, hash_num)
    return _signature_launch(minhash_signature, key, indices, values,
                             hash_num, hash_num)


minhash_signature.launches = 0


def signature(key, indices: torch.Tensor, values: torch.Tensor,
              hash_num: int, kind: str, padded_b: Optional[int] = None
              ) -> torch.Tensor:
    """The kind's signature: [B, K] -> [B, sig_width] int32, signed as in
    a batch of padded_b datums (lsh_signature; minhash's argmin has no
    order)."""
    if kind == "minhash":
        return minhash_signature(key, indices, values, hash_num)
    return lsh_signature(key, indices, values, hash_num, padded_b)


# ---------------------------------------------------------------------------
# the table sweep with its selection: plain version and the K3 wrapper
# ---------------------------------------------------------------------------

def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 holding a uint32 value (torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


@functools.lru_cache(maxsize=64)
def count_table(kind: str, hash_num: int) -> np.ndarray:
    """float32 [C + 1]: what a sweep takes from a row's count c (the
    popcount of the xor, at most C = 32 * words_for(H), or minhash's
    equal slots, at most C = H), as XLA computes it
    from _sig_similarities.  XLA turns the division by the constant H
    into a product with f32(1/H), folds the constants together and
    fuses a multiply-add where it can, so:
      lsh        1 - c * r         (one fused multiply-add, r = f32(1/H))
      minhash    c * r
      euclid_lsh cos(c * f32(f32(pi) * r)), as the C library's cosf
                 gives it (XLA's CPU code calls cosf, which is one ulp
                 off the correctly rounded cosine at a few counts above
                 H 96: c 55 at H 128)
    Float64 arithmetic rounded once to float32 gives the fused results
    (c * r is exact there)."""
    top = hash_num if kind == "minhash" else 32 * words_for(hash_num)
    c = np.arange(top + 1, dtype=np.float32)
    r = np.float32(1.0) / np.float32(hash_num)
    if kind == "lsh":
        return (1.0 - c.astype(np.float64) * np.float64(r)).astype(
            np.float32)
    if kind == "minhash":
        return c * r
    ang = c * (np.float32(math.pi) * r)
    cosf = _libm_cosf()
    return np.array([cosf(float(a)) for a in ang], np.float32)


@functools.lru_cache(maxsize=64)
def _count_table_dev(kind: str, hash_num: int,
                     device: torch.device) -> torch.Tensor:
    """count_table on `device` (a copy; callers only read it)."""
    return torch.tensor(count_table(kind, hash_num), device=device)


def similarities_ref(kind: str, table: torch.Tensor, q_sig: torch.Tensor,
                     norms: torch.Tensor, qnorm: torch.Tensor,
                     hash_num: int) -> torch.Tensor:
    """_sig_similarities of the JAX package as XLA computes it: float32
    scores [R] of one query signature [W] against every row of table
    [R, W] (higher is closer).  lsh and minhash scores and the euclid
    cosine come from count_table; the euclid estimate is
    -sqrt(max(fma(-t, cos, fma(n, n, qn * qn)), 0)), t = 2 * qn * n, the
    multiply-adds fused as XLA fuses them (in float64, rounded once) and
    the root correctly rounded (_sqrt)."""
    tab = _count_table_dev(kind, hash_num, table.device)
    if kind == "minhash":
        return tab[(table == q_sig[None, :]).sum(1)]
    x = (table ^ q_sig[None, :]).to(torch.int64) & MASK32
    cos = tab[_popcount(x).sum(1)]
    if kind == "lsh":
        return cos
    qq = (qnorm * qnorm).double()
    a = (norms.double() * norms.double() + qq).float()
    t = (2.0 * qnorm) * norms
    d2 = (a.double() - t.double() * cos.double()).float()
    return -_sqrt(torch.clamp_min(d2, 0.0))


def scores_to_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 scores [..., R] -> unique order-preserving int64 keys: the
    score's bits, with the low 31 flipped where negative, in the high
    word (a signed int32 that orders as the floats do), 0xFFFFFFFF - row
    in the low word (the lower row wins a tie)."""
    b = scores.contiguous().view(torch.int32).to(torch.int64)
    s = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    r = torch.arange(scores.shape[-1], dtype=torch.int64,
                     device=scores.device)
    return (s << 32) | (MASK32 - r)


def keys_to_rows_scores(keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of scores_to_keys: (rows int64, scores float32)."""
    s = keys >> 32
    b = torch.where(s < 0, s ^ 0x7FFFFFFF, s).to(torch.int32)
    return MASK32 - (keys & MASK32), b.view(torch.float32)


def _valid_rows(r: int, n_valid: int, mask: Optional[torch.Tensor],
                device) -> torch.Tensor:
    """bool [r]: the rows below n_valid that the mask (bool or uint8 [r],
    None: every row) keeps."""
    ok = torch.arange(r, device=device) < int(n_valid)
    if mask is not None:
        ok &= mask.to(torch.bool)
    return ok


def sig_sweep_ref(kind: str, table: torch.Tensor, norms: torch.Tensor,
                  n_valid: int, q_sigs: torch.Tensor, qnorms: torch.Tensor,
                  hash_num: int, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The key of every (query, row): int64 [Nq, R] of each query
    signature (q_sigs [Nq, W], qnorms [Nq]) against the table, the rows
    from n_valid on, and those the mask leaves out, at -inf.  The first
    step of sig_topk_ref."""
    r = table.shape[0]
    mask = _valid_rows(r, n_valid, mask, table.device)
    keys = []
    for q in range(q_sigs.shape[0]):
        s = similarities_ref(kind, table, q_sigs[q], norms, qnorms[q],
                             hash_num)
        keys.append(scores_to_keys(torch.where(mask, s, -math.inf)))
    if not keys:
        return torch.empty((0, r), dtype=torch.int64, device=table.device)
    return torch.stack(keys)


def sig_topk_ref(kind: str, table: torch.Tensor, norms: torch.Tensor,
                 n_valid: int, q_sigs: torch.Tensor, qnorms: torch.Tensor,
                 hash_num: int, kb: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3: each query's top kb keys [Nq, kb], descending
    (sig_sweep_ref, then torch.topk over its unique keys: the order is
    the keys' own, jax.lax.top_k's)."""
    keys = sig_sweep_ref(kind, table, norms, n_valid, q_sigs, qnorms,
                         hash_num, mask)
    return torch.topk(keys, kb, dim=1, largest=True, sorted=True).values


def _check_mask(mask: Optional[torch.Tensor], r: int, dev,
                what: str) -> None:
    if mask is None:
        return
    if (mask.dtype not in (torch.bool, torch.uint8) or mask.shape != (r,)
            or mask.device != dev or not mask.is_contiguous()):
        raise ValueError(f"{what}: the mask must be a contiguous bool or "
                         f"uint8 [{r}] tensor on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")


def _sig_topk_args(kind, table, n_valid, q_sigs, q_rows, kb) -> None:
    if kind not in SIG_KINDS:
        raise ValueError(f"unknown signature kind: {kind}")
    if not isinstance(n_valid, (int, np.integer)):
        raise ValueError(f"sig_topk: n_valid is a row count, not "
                         f"{type(n_valid).__name__}")
    r = table.shape[0]
    if not 0 <= int(n_valid) <= r:
        raise ValueError(f"sig_topk: {n_valid} valid rows of {r}")
    if not 1 <= int(kb) <= r:
        raise ValueError(f"sig_topk: kb {kb} outside [1, {r}]")
    if (q_rows is None) == (q_sigs is None):
        raise ValueError("sig_topk: give q_sigs (with qnorms) or q_rows")


def sig_topk(kind: str, table: torch.Tensor, norms: torch.Tensor,
             n_valid: int,
             q_sigs: Optional[torch.Tensor] = None,
             qnorms: Optional[torch.Tensor] = None,
             q_rows: Optional[torch.Tensor] = None,
             hash_num: int = 0, kb: int = 8,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each query's top kb keys [Nq, kb] int64, descending, against table
    [R, W] (int32), norms [R] float32, of which the rows below n_valid
    that the mask (bool or uint8 [R] on the table's device, None: every
    row) keeps are valid; the others score -inf and fill in, the lowest
    rows first, where fewer than kb are valid, as jax.lax.top_k places
    them.  The queries are signatures q_sigs [Nq, W] with
    qnorms [Nq], or stored rows q_rows [Nq] int64, each in [0, R) (the
    kernel gathers their signatures and norms).  1 <= kb <= R.  CUDA
    tensors: one launch of K3 (csrc/lsh.cu), with its scratch from
    torch.empty; CPU: the plain version."""
    _sig_topk_args(kind, table, n_valid, q_sigs, q_rows, kb)
    _check_mask(mask, table.shape[0], table.device, "sig_topk")
    if table.device.type == "cpu":
        if q_rows is not None:
            q_sigs, qnorms = table[q_rows], norms[q_rows]
        return sig_topk_ref(kind, table, norms, int(n_valid), q_sigs,
                            qnorms, hash_num, int(kb), mask)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(table, torch.int32, dev, "sig_topk table")
    _check(norms, torch.float32, dev, "sig_topk norms")
    r, w = table.shape
    if w != sig_width(kind, hash_num) or norms.shape != (r,):
        raise ValueError(f"sig_topk: table {tuple(table.shape)} / norms "
                         f"{tuple(norms.shape)} do not fit {kind} at "
                         f"hash_num {hash_num}")
    if r >= MASK32:
        raise ValueError(f"sig_topk: {r} rows do not fit the 32-bit row "
                         f"word of a key")
    if q_rows is not None:
        _check(q_rows, torch.int64, dev, "sig_topk q_rows")
        if q_rows.dim() != 1:
            raise ValueError("sig_topk: q_rows must be [Nq]")
        nq = q_rows.shape[0]
        qs_ptr = qn_ptr = 0
        qr_ptr = q_rows.data_ptr()
    else:
        _check(q_sigs, torch.int32, dev, "sig_topk q_sigs")
        _check(qnorms, torch.float32, dev, "sig_topk qnorms")
        nq = q_sigs.shape[0]
        if q_sigs.shape != (nq, w) or qnorms.shape != (nq,):
            raise ValueError("sig_topk: query shapes do not fit the table")
        qs_ptr, qn_ptr, qr_ptr = q_sigs.data_ptr(), qnorms.data_ptr(), 0
    kb = int(kb)
    out = torch.empty((nq, kb), dtype=torch.int64, device=dev)
    if nq == 0:
        return out
    lib = _lib()
    ws_bytes = lib.sig_topk_workspace(r, w, nq, kb, int(n_valid),
                                      SIG_KINDS.index(kind))
    if ws_bytes < 0:
        raise ValueError(f"sig_topk: no plan for R {r}, W {w}, Nq {nq}, "
                         f"kb {kb}, {n_valid} valid rows")
    ws = torch.empty(max(ws_bytes, 8), dtype=torch.uint8, device=dev)
    tab = _count_table_dev(kind, hash_num, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sig_topk_launch(
        table.data_ptr(), norms.data_ptr(), int(n_valid), qs_ptr, qn_ptr,
        qr_ptr, 0 if mask is None else mask.data_ptr(), tab.data_ptr(), r,
        w, nq, SIG_KINDS.index(kind), kb, ws.data_ptr(), ws_bytes,
        out.data_ptr(), stream)
    sig_topk.launches += 1
    build.check(err, "sig_topk launch")
    return out


sig_topk.launches = 0

TOPK_PATHS = ("fast", "sort")
TOPK_MODES = ("direct", "staged", "split")


def topk_plan(rows: int, width: int, nq: int, kb: int, n_valid: int,
              kind: str = "lsh") -> dict:
    """K3's launch plan for a shape (the card's library): its path
    (fast: the lists; sort: kb > 1024 or a query too wide), how rows are
    read (direct, staged, split), the queries a block, the blocks over
    the rows, the rows a block and the list length."""
    out = (ctypes.c_longlong * 6)()
    err = _lib().sig_topk_plan(rows, width, nq, kb, n_valid,
                               SIG_KINDS.index(kind), ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"sig_topk: no plan for R {rows}, W {width}, "
                         f"Nq {nq}, kb {kb}, {n_valid} valid rows")
    return {"path": TOPK_PATHS[out[0]], "mode": TOPK_MODES[out[1]],
            "query_chunk": int(out[2]), "blocks": int(out[3]),
            "rows_per_block": int(out[4]), "list_len": int(out[5])}


# ---------------------------------------------------------------------------
# the fused query routes (ops/lsh.py _fused_sig_query*)
# ---------------------------------------------------------------------------

def _round_k(k: int) -> int:
    """The JAX package's top-k width bucket (8, 16, 32, ...)."""
    x = 8
    while x < k:
        x *= 2
    return x


def keys_to_host(keys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Top keys [Nq, kb] -> host (rows [Nq, kb] int64, scores [Nq, kb]
    float32): one copy, the decode on the host."""
    rows, scores = keys_to_rows_scores(keys.cpu())
    return rows.numpy(), scores.numpy()


def _kb(k: int, n_rows: int) -> int:
    return min(_round_k(k), n_rows or 1)


def _host(x, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(x, dtype)
    if not a.flags.writeable:              # a view of wire or file bytes
        a = a.copy()
    return torch.from_numpy(a).to(device)


def fused_sig_query_batch(kind: str, key, q_indices: np.ndarray,
                          q_values: np.ndarray, table: torch.Tensor,
                          norms: torch.Tensor, n_valid: int, hash_num: int,
                          qnorms, k: int, padded_b: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """[Nq] datum queries: signatures (K1/K2, signed as in a batch of
    padded_b), then the sweep with its selection (K3, over the rows below
    n_valid that the mask keeps) -> (rows [Nq, k'], scores [Nq, k'])
    numpy, k' = min(_round_k(k), R); the caller trims and drops
    non-finite entries."""
    dev = table.device
    idx = _host(q_indices, np.int32, dev)
    val = _host(q_values, np.float32, dev)
    q_sigs = signature(key, idx, val, hash_num, kind, padded_b)
    return keys_to_host(sig_topk(
        kind, table, norms, n_valid, q_sigs=q_sigs,
        qnorms=_host(qnorms, np.float32, dev), hash_num=hash_num,
        kb=_kb(k, table.shape[0]), mask=mask))


def fused_sig_query(kind: str, key, q_indices, q_values, table, norms,
                    n_valid: int, hash_num: int, qnorm: float, k: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One datum query -> (rows [k'], scores [k']); norms may be None
    (zeros) for the kinds that do not read them."""
    if norms is None:
        norms = torch.zeros(table.shape[0], dtype=torch.float32,
                            device=table.device)
    rows, scores = fused_sig_query_batch(
        kind, key, q_indices, q_values, table, norms, n_valid, hash_num,
        [qnorm], k, mask=mask)
    return rows[0], scores[0]


def fused_sig_query_row(kind: str, table: torch.Tensor, row: int,
                        norms: torch.Tensor, n_valid: int, hash_num: int,
                        k: int, mask: Optional[torch.Tensor] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Query by a stored row: the kernel gathers its signature and norm
    on the device (no host readback before the sweep)."""
    if not 0 <= int(row) < table.shape[0]:
        raise IndexError(f"row {row} outside the table's {table.shape[0]}")
    q_rows = torch.tensor([int(row)], dtype=torch.int64, device=table.device)
    rows, scores = keys_to_host(sig_topk(
        kind, table, norms, n_valid, q_rows=q_rows, hash_num=hash_num,
        kb=_kb(k, table.shape[0]), mask=mask))
    return rows[0], scores[0]


def sig_query_args(q_sig, qnorm: float, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A raw query signature [W] (uint32 or int32, as it crossed the wire)
    and its norm -> (q_sigs [1, W] int32 bit patterns, qnorms [1] float32)
    on `device`: the norm rounds to float32 as the JAX route's
    np.float32(qnorm) does."""
    sig = np.ascontiguousarray(q_sig).reshape(1, -1)
    if sig.dtype.itemsize != 4 or sig.dtype.kind not in "iu":
        raise ValueError(f"a query signature is 32-bit words, got "
                         f"{sig.dtype}")
    return (_host(sig.view(np.int32), np.int32, device),
            _host([np.float32(qnorm)], np.float32, device))


def fused_sig_query_sig(kind: str, table: torch.Tensor, q_sig, qnorm: float,
                        norms: torch.Tensor, n_valid: int, hash_num: int,
                        k: int, mask: Optional[torch.Tensor] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Query by a raw signature (the partition plane's from_id legs: the
    id's owner resolved it to its stored signature and norm, and every
    partition sweeps its own rows with them): one K3 launch with q_sigs
    [1, W] and qnorms [1], the rows below n_valid that the mask keeps
    valid, kb = min(_round_k(k), R) -> (rows [kb], scores [kb])."""
    q_sigs, qnorms = sig_query_args(q_sig, qnorm, table.device)
    rows, scores = keys_to_host(sig_topk(
        kind, table, norms, n_valid, q_sigs=q_sigs, qnorms=qnorms,
        hash_num=hash_num, kb=_kb(k, table.shape[0]), mask=mask))
    return rows[0], scores[0]


def host_signature(key, indices: np.ndarray, values: np.ndarray,
                   hash_num: int, kind: str,
                   device: Union[str, torch.device],
                   padded_b: Optional[int] = None) -> np.ndarray:
    """Signatures of a host batch computed on `device` -> uint32 numpy
    [B, sig_width], signed as in a batch of padded_b datums."""
    dev = torch.device(device)
    sig = signature(key, _host(indices, np.int32, dev),
                    _host(values, np.float32, dev), hash_num, kind,
                    padded_b)
    return sig.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the exact sweeps of the sparse row table (K4) and the all-rows signature
# counts (K5): plain versions, wrappers and the routes of the JAX package
# (ops/lsh.py _fused_dense_query, table_similarities_batch; anomaly's
# _chunk_dots)
# ---------------------------------------------------------------------------

DENSE_METRICS = ("cosine", "euclid")


def dense_scores_ref(metric: str, indices: torch.Tensor,
                     values: torch.Tensor, norms: torch.Tensor,
                     q_dense: torch.Tensor, qnorm: torch.Tensor
                     ) -> torch.Tensor:
    """_fused_dense_query's scores of one dense query q_dense [D] (qnorm, a
    float32 0-d tensor) against every stored row (indices/values [R, Kr],
    norms [R]) as XLA's CPU code computes them: the einsum's dot
    (ops.sparse.xla_dot_rows "einsum"), then cosine dots / max(n * qn,
    1e-12), or euclid -sqrt(max(fma(n, n, qn * qn) - 2 * dots, 0)),
    flushed as XLA flushes."""
    from jubatus_tpu_torch.ops.sparse import xla_dot_rows
    dots = xla_dot_rows(q_dense[indices.long()], values, "einsum")
    n = ftz(norms)
    qn = ftz(qnorm)
    if metric == "cosine":
        return ftz(dots / torch.clamp_min(ftz(n * qn), 1e-12))
    a = ftz(_fma(n, n, ftz(qn * qn).expand_as(n)))
    return -_sqrt(torch.clamp_min(ftz(a - 2.0 * dots), 0.0))


def dense_topk_ref(metric: str, indices: torch.Tensor, values: torch.Tensor,
                   norms: torch.Tensor, n_valid: int,
                   mask: Optional[torch.Tensor], q_dense: torch.Tensor,
                   qnorms: torch.Tensor, kb: int) -> torch.Tensor:
    """Plain version of K4's dense_topk: each query's (q_dense [Nq, D],
    qnorms [Nq]) top kb keys [Nq, kb] over the rows below n_valid that the
    mask keeps (the rest at -inf), in jax.lax.top_k's order."""
    ok = _valid_rows(indices.shape[0], n_valid, mask, indices.device)
    keys = [scores_to_keys(torch.where(
        ok, dense_scores_ref(metric, indices, values, norms, q_dense[q],
                             qnorms[q]), -math.inf))
            for q in range(q_dense.shape[0])]
    if not keys:
        return torch.empty((0, kb), dtype=torch.int64)
    return torch.topk(torch.stack(keys), kb, dim=1).values


def dense_dots_ref(indices: torch.Tensor, values: torch.Tensor,
                   q_dense: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's dense_dots: dots [C, R] of every stored row
    with each dense query of q_dense [C, D], as XLA's CPU code computes
    anomaly's _chunk_dots, jnp.sum(q[:, indices] * values, -1)
    (ops.sparse.xla_dot_rows "sum")."""
    from jubatus_tpu_torch.ops.sparse import xla_dot_rows
    return xla_dot_rows(q_dense[:, indices.long()], values[None], "sum")


def _dense_args(indices, values, q_dense, what: str) -> None:
    dev = indices.device
    _check(indices, torch.int32, dev, f"{what} indices")
    _check(values, torch.float32, dev, f"{what} values")
    _check(q_dense, torch.float32, dev, f"{what} q_dense")
    if indices.dim() != 2 or values.shape != indices.shape:
        raise ValueError(f"{what}: indices {tuple(indices.shape)} and values "
                         f"{tuple(values.shape)} differ")
    if q_dense.dim() != 2:
        raise ValueError(f"{what}: q_dense must be [Nq, D]")
    kr = indices.shape[1]
    if (kr > 16 and kr % 32) or (kr > 1024 and kr % 1024):
        raise ValueError(f"{what}: a row width of {kr} (above 16 and no "
                         f"multiple of 32, or above 1024 and no multiple "
                         f"of 1024) has no known XLA order")
    if kr % 4 == 0 and (indices.data_ptr() % 16 or values.data_ptr() % 16):
        raise ValueError(f"{what}: the kernel copies rows 16 bytes at a "
                         f"time; indices and values must start on a "
                         f"16-byte boundary")


def dense_topk(metric: str, indices: torch.Tensor, values: torch.Tensor,
               norms: torch.Tensor, n_valid: int,
               mask: Optional[torch.Tensor], q_dense: torch.Tensor,
               qnorms: torch.Tensor, kb: int) -> torch.Tensor:
    """Each dense query's top kb keys [Nq, kb] int64 over the stored rows
    (indices int32 / values float32 [R, Kr], norms [R]) below n_valid that
    the mask keeps, scored as dense_scores_ref.  CUDA tensors: one launch
    of K4's dense_topk (csrc/lsh.cu: persistent blocks stream row tiles
    through a ring in shared memory, the gather-dot in XLA's order with
    fmaf, then K3's lists and merge, or above kb 1024 K3's bitonic sort
    of every row's key); CPU: the plain version."""
    if metric not in DENSE_METRICS:
        raise ValueError(f"unknown dense metric {metric!r}")
    r = indices.shape[0]
    if not 0 <= int(n_valid) <= r or not 1 <= int(kb) <= r:
        raise ValueError(f"dense_topk: n_valid {n_valid}, kb {kb} of {r}")
    _check_mask(mask, r, indices.device, "dense_topk")
    if indices.device.type == "cpu":
        return dense_topk_ref(metric, indices, values, norms, int(n_valid),
                              mask, q_dense, qnorms, int(kb))
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _dense_args(indices, values, q_dense, "dense_topk")
    _check(norms, torch.float32, dev, "dense_topk norms")
    _check(qnorms, torch.float32, dev, "dense_topk qnorms")
    nq, d = q_dense.shape
    if norms.shape != (r,) or qnorms.shape != (nq,):
        raise ValueError("dense_topk: norms / qnorms do not fit")
    kb = int(kb)
    out = torch.empty((nq, kb), dtype=torch.int64, device=dev)
    if nq == 0:
        return out
    lib = _lib()
    ws_bytes = lib.dense_topk_workspace(r, indices.shape[1], d, nq, kb,
                                        int(n_valid))
    if ws_bytes < 0:
        raise ValueError(f"dense_topk: no plan for R {r}, Nq {nq}, kb {kb}")
    ws = torch.empty(max(ws_bytes, 8), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dense_topk_launch(
        indices.data_ptr(), values.data_ptr(), norms.data_ptr(),
        int(n_valid), 0 if mask is None else mask.data_ptr(),
        q_dense.data_ptr(), qnorms.data_ptr(), r, indices.shape[1], d, nq,
        DENSE_METRICS.index(metric), kb, ws.data_ptr(), ws_bytes,
        out.data_ptr(), stream)
    dense_topk.launches += 1
    build.check(err, "dense_topk launch")
    return out


dense_topk.launches = 0


def dense_dots(indices: torch.Tensor, values: torch.Tensor,
               q_dense: torch.Tensor) -> torch.Tensor:
    """dots [C, R] float32 of every stored row (indices int32 / values
    float32 [R, Kr]) with each dense query of q_dense [C, D], in XLA's
    order of _chunk_dots.  CUDA tensors: one launch of K4's dense_dots
    (csrc/lsh.cu: the ring of row tiles, 8 lanes a row at Kr 32); CPU:
    the plain version."""
    if indices.device.type == "cpu":
        return dense_dots_ref(indices, values, q_dense)
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _dense_args(indices, values, q_dense, "dense_dots")
    r, kr = indices.shape
    c, d = q_dense.shape
    out = torch.empty((c, r), dtype=torch.float32, device=dev)
    if c == 0 or r == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().dense_dots_launch(indices.data_ptr(), values.data_ptr(),
                                   q_dense.data_ptr(), r, kr, d, c,
                                   out.data_ptr(), stream)
    dense_dots.launches += 1
    build.check(err, "dense_dots launch")
    return out


dense_dots.launches = 0


@functools.lru_cache(maxsize=None)
def _libm_cosf():
    import ctypes.util
    f = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    f.restype = ctypes.c_float
    f.argtypes = [ctypes.c_float]
    return f


@functools.lru_cache(maxsize=64)
def euclid_cos_table(hash_num: int) -> np.ndarray:
    """float32 [C + 1]: the cosine _euclid_b takes from a hamming count c
    (C = 32 * words_for(H)): cos(f32(f32(pi) * c) / f32(H)), H a traced
    argument there, so a true division; XLA's CPU code calls the C
    library's cosf, which is not always the correctly rounded cosine
    (one ulp off at a few counts above H 96), so the table calls it too."""
    cosf = _libm_cosf()
    c = np.arange(32 * words_for(hash_num) + 1, dtype=np.float32)
    ang = (np.float32(math.pi) * c) / np.float32(hash_num)
    return np.array([cosf(float(a)) for a in ang], np.float32)


@functools.lru_cache(maxsize=64)
def _euclid_cos_dev(hash_num: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(euclid_cos_table(hash_num), device=device)


def euclid_estimates_ref(counts: torch.Tensor, norms: torch.Tensor,
                         qnorms: torch.Tensor, hash_num: int) -> torch.Tensor:
    """_euclid_b (euclid_scores of every (query, row)) as XLA computes it
    from hamming counts [Nq, R]: sqrt(max(fma(-t, cos, fma(n, n, qn *
    qn)), 0)), t = 2 * qn * n, cos from euclid_cos_table."""
    cos = _euclid_cos_dev(hash_num, counts.device)[counts.long()]
    n = norms[None, :]
    qn = qnorms[:, None]
    a = _fma(n.expand_as(cos), n.expand_as(cos), (qn * qn).expand_as(cos))
    return _sqrt(torch.clamp_min(_fma(-((2.0 * qn) * n), cos, a), 0.0))


def sig_counts_ref(kind: str, table: torch.Tensor, q_sigs: torch.Tensor,
                   norms: torch.Tensor, qnorms: torch.Tensor,
                   hash_num: int) -> torch.Tensor:
    """Plain version of K5: every (query, row) of q_sigs [Nq, W] against
    table [R, W]: int32 popcount(xor) counts for lsh, equal words for
    minhash, float32 euclid estimates (euclid_estimates_ref) for
    euclid_lsh -> [Nq, R]."""
    out = []
    for q in range(q_sigs.shape[0]):
        if kind == "minhash":
            out.append((table == q_sigs[q][None, :]).sum(1))
        else:
            x = (table ^ q_sigs[q][None, :]).to(torch.int64) & MASK32
            out.append(_popcount(x).sum(1))
    if not out:
        cnt = torch.empty((0, table.shape[0]), dtype=torch.int32)
    else:
        cnt = torch.stack(out).to(torch.int32)
    if kind == "euclid_lsh":
        return euclid_estimates_ref(cnt, norms, qnorms, hash_num)
    return cnt


# K5's plan (csrc/lsh.cu); its design: 0 direct (up to 16 words a row),
# 1 the ring (wider rows)
SIG_COUNTS_PLAN_KEYS = ("design", "words_a_lane", "lanes_a_row", "slab",
                        "slabs", "tile_rows", "stride", "stages",
                        "queries_a_group", "groups", "blocks", "copy_bytes",
                        "smem_bytes")


def sig_counts_plan(kind: str, rows: int, hash_num: int, nq: int,
                    table_ptr: int = 0) -> dict:
    """K5's plan on this card for a sweep of `rows` rows for `nq` queries
    (table_ptr: the table's address, whose alignment picks the copies):
    SIG_COUNTS_PLAN_KEYS -> ints."""
    out = (ctypes.c_int * len(SIG_COUNTS_PLAN_KEYS))()
    build.check(_lib().sig_counts_plan(
        rows, sig_width(kind, hash_num), nq, SIG_KINDS.index(kind),
        table_ptr, out), "sig_counts plan")
    return dict(zip(SIG_COUNTS_PLAN_KEYS, list(out)))


def _sig_counts_args(kind, table, q_sigs, norms, qnorms, hash_num, what):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(table, torch.int32, dev, f"{what} table")
    _check(q_sigs, torch.int32, dev, f"{what} q_sigs")
    _check(norms, torch.float32, dev, f"{what} norms")
    _check(qnorms, torch.float32, dev, f"{what} qnorms")
    r, w = table.shape
    nq = q_sigs.shape[0]
    if (w != sig_width(kind, hash_num) or q_sigs.shape != (nq, w)
            or norms.shape != (r,) or qnorms.shape != (nq,)):
        raise ValueError(f"{what}: shapes do not fit the table")


def _k5_launch(wrapper, kind, table, q_sigs, norms, qnorms, tab, scores,
               out) -> torch.Tensor:
    """One K5 launch into out [Nq, R], counted on `wrapper`."""
    r, w = table.shape
    nq = q_sigs.shape[0]
    if nq == 0 or r == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    launch = _lib().sig_scores_launch if scores else _lib().sig_counts_launch
    err = launch(
        table.data_ptr(), q_sigs.data_ptr(), norms.data_ptr(),
        qnorms.data_ptr(), tab.data_ptr(), r, w, nq, SIG_KINDS.index(kind),
        out.data_ptr(), stream)
    wrapper.launches += 1
    build.check(err, f"{wrapper.__name__} launch")
    return out


def sig_counts(kind: str, table: torch.Tensor, q_sigs: torch.Tensor,
               norms: torch.Tensor, qnorms: torch.Tensor,
               hash_num: int) -> torch.Tensor:
    """[Nq, R] counts (lsh, minhash: int32) or euclid estimates
    (euclid_lsh: float32) of every query signature against every row.
    CUDA tensors: one launch of K5 (csrc/lsh.cu); CPU: the plain
    version."""
    if kind not in SIG_KINDS:
        raise ValueError(f"unknown signature kind: {kind}")
    if table.device.type == "cpu":
        return sig_counts_ref(kind, table, q_sigs, norms, qnorms, hash_num)
    _sig_counts_args(kind, table, q_sigs, norms, qnorms, hash_num,
                     "sig_counts")
    dev = table.device
    euclid = kind == "euclid_lsh"
    out = torch.empty((q_sigs.shape[0], table.shape[0]),
                      dtype=torch.float32 if euclid else torch.int32,
                      device=dev)
    tab = _euclid_cos_dev(hash_num, dev) if euclid else norms
    return _k5_launch(sig_counts, kind, table, q_sigs, norms, qnorms, tab,
                      False, out)


sig_counts.launches = 0


def sig_scores_ref(kind: str, table: torch.Tensor, q_sigs: torch.Tensor,
                   norms: torch.Tensor, qnorms: torch.Tensor,
                   hash_num: int) -> torch.Tensor:
    """Plain version of K5's scores mode: float32 [Nq, R], row q the
    similarities_ref of query q (q_sigs [Nq, W], qnorms [Nq]) against
    every row of table [R, W] (_sig_similarities as XLA computes it)."""
    rows = [similarities_ref(kind, table, q_sigs[q], norms, qnorms[q],
                             hash_num) for q in range(q_sigs.shape[0])]
    if not rows:
        return torch.empty((0, table.shape[0]), dtype=torch.float32,
                           device=table.device)
    return torch.stack(rows)


def sig_scores(kind: str, table: torch.Tensor, q_sigs: torch.Tensor,
               norms: torch.Tensor, qnorms: torch.Tensor,
               hash_num: int) -> torch.Tensor:
    """[Nq, R] float32 _sig_similarities scores (higher is closer: lsh
    1 - d/H, minhash m/H, euclid_lsh minus the estimate) of every query
    signature against every row.  CUDA tensors: one launch of K5 in its
    scores mode (csrc/lsh.cu: K5's counts, then K3's score() from K3's
    count table, so the bits are the fused sweep's); CPU: the plain
    version."""
    if kind not in SIG_KINDS:
        raise ValueError(f"unknown signature kind: {kind}")
    if table.device.type == "cpu":
        return sig_scores_ref(kind, table, q_sigs, norms, qnorms, hash_num)
    _sig_counts_args(kind, table, q_sigs, norms, qnorms, hash_num,
                     "sig_scores")
    dev = table.device
    out = torch.empty((q_sigs.shape[0], table.shape[0]),
                      dtype=torch.float32, device=dev)
    return _k5_launch(sig_scores, kind, table, q_sigs, norms, qnorms,
                      _count_table_dev(kind, hash_num, dev), True, out)


sig_scores.launches = 0


def table_similarities_batch(kind: str, table: torch.Tensor, q_sigs,
                             hash_num: int, norms: torch.Tensor,
                             qnorms) -> np.ndarray:
    """The JAX package's table_similarities_batch: [Nq, R] float64 on the
    host of query signatures q_sigs [Nq, W] (uint32 numpy or an int32
    tensor) against every row: lsh 1 - hamming/H, minhash equal/H (the
    device's int32 counts, the float64 arithmetic on the host, as there),
    euclid_lsh minus the estimate.  One K5 launch and one copy."""
    dev = table.device
    if not isinstance(q_sigs, torch.Tensor):
        q_sigs = _host(np.asarray(q_sigs, np.uint32).view(np.int32),
                       np.int32, dev)
    out = sig_counts(kind, table, q_sigs, norms,
                     _host(qnorms, np.float32, dev), hash_num).cpu().numpy()
    if kind == "minhash":
        return out.astype(np.float64) / hash_num
    if kind == "lsh":
        return 1.0 - out.astype(np.float64) / hash_num
    return -out.astype(np.float64)


def fused_dense_query(metric: str, indices: torch.Tensor,
                      values: torch.Tensor, norms: torch.Tensor, n_valid: int,
                      mask: Optional[torch.Tensor], q_dense: np.ndarray,
                      qnorm: float, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """_fused_dense_query: one dense query [D] (host) -> (rows [k'],
    scores [k']) numpy, k' = min(_round_k(k), R), through dense_topk."""
    dev = indices.device
    keys = dense_topk(metric, indices, values, norms, n_valid, mask,
                      _host(np.asarray(q_dense, np.float32)[None], np.float32,
                            dev),
                      _host([qnorm], np.float32, dev),
                      _kb(k, indices.shape[0]))
    rows, scores = keys_to_host(keys)
    return rows[0], scores[0]


def topk_rows(scores: np.ndarray, valid: np.ndarray, k: int, largest: bool):
    """Host top-k over a scored row table -> (row indices, scores): the
    JAX package's topk_rows (ops/lsh.py), an argpartition then a stable
    argsort of the k."""
    scores = np.where(valid, scores, -np.inf if largest else np.inf)
    n = int(valid.sum())
    k = min(k, n)
    if k <= 0:
        return np.empty(0, np.int64), np.empty(0, scores.dtype)
    if largest:
        part = np.argpartition(-scores, k - 1)[:k]
        order = part[np.argsort(-scores[part], kind="stable")]
    else:
        part = np.argpartition(scores, k - 1)[:k]
        order = part[np.argsort(scores[part], kind="stable")]
    return order, scores[order]
