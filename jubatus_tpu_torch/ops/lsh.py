"""Locality-sensitive hashing over hashed sparse batches (counterpart of
jubatus_tpu/ops/lsh.py).

Signatures are part of the model: rows written by one server are compared
with queries signed by another, and model files, MIX diffs and journals
move between this package and the JAX one.  So the random numbers are
jax's own: threefry2x32 (jax_threefry_partitionable), fold_in, and jax's
uniform and normal transforms, reproduced bit for bit here (the bits and
the uniforms exactly; the normals through XLA's float32 erf_inv
polynomial with its fused multiply-adds, within 3 ulp of XLA's, whose
log1p differs in the last bits).

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

Three hand kernels in csrc/lsh.cu do the work on the card (K1
lsh_signature, K2 minhash_signature, K3 sig_topk: the sweep with its
top-kb selection, so only [Nq, kb] keys leave the card); each wrapper
below launches its kernel for a CUDA tensor, raising where it cannot,
and runs the plain PyTorch version (the *_ref functions) for a CPU
tensor.
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
    """jax's _uniform: the top 23 bits as the mantissa of [1, 2), minus
    1, scaled into [minval, maxval) in float32, floored at minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv, operation by operation.  XLA's CPU code
    contracts each step c + p * w of the polynomial into a fused
    multiply-add, so this one does too: p * w is exact in float64 and the
    sum rounds once more to float32 (csrc/lsh.cu takes fmaf).  The normals
    then equal jax's in about 99% of draws and lie within 3 ulp of them
    otherwise (XLA's own log1p)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    wd = w.double()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, a, b).to(torch.float32)
        p = (c.double() + p.double() * wd).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's float32 draw from its random bits."""
    return _SQRT2 * erf_inv(uniform_from_bits(bits, _NORMAL_LO, 1.0))


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


def lsh_signature_ref(key, indices: torch.Tensor, values: torch.Tensor,
                      hash_num: int) -> torch.Tensor:
    """Plain version of K1: [B, K] -> [B, ceil(H/32)] int32.  The
    projection sums feature by feature in k order in float32, as the
    kernel does (XLA's einsum sums in its own order: signature bits may
    differ where the projection is within rounding of zero)."""
    b, k = indices.shape
    proj = torch.zeros((b, hash_num), dtype=torch.float32,
                       device=indices.device)
    for j in range(k):
        f1, f2 = fold_in(key, indices[:, j])
        row = normal_from_bits(random_bits(f1, f2, hash_num))
        proj = proj + values[:, j:j + 1] * row
    return _pack_bits(proj >= 0)


def minhash_signature_ref(key, indices: torch.Tensor, values: torch.Tensor,
                          hash_num: int) -> torch.Tensor:
    """Plain version of K2: [B, K] -> [B, H] int32 (uint32 feature
    indices), the first k winning ties, slot 0 where every value is 0."""
    b, k = indices.shape
    best_e = None
    best_k = torch.zeros((b, hash_num), dtype=torch.int64,
                         device=indices.device)
    for j in range(k):
        f1, f2 = fold_in(key, indices[:, j])
        u = uniform_from_bits(random_bits(f1, f2, hash_num), _MINHASH_LO,
                              1.0)
        w = values[:, j:j + 1].abs()
        e = torch.where(w > 0, -torch.log(u) / torch.clamp_min(
            w, _MINHASH_LO), math.inf)
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
    for fn in (lib.lsh_signature_launch, lib.minhash_signature_launch):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_uint32] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.sig_topk_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
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
                      width: int) -> torch.Tensor:
    """One launch of the kernel of `wrapper` (lsh_signature or
    minhash_signature), counted on it."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_lib(), f"{fn_name}_launch")(
        indices.data_ptr(), values.data_ptr(), out.data_ptr(),
        key[0] & MASK32, key[1] & MASK32, b, k, hash_num, stream)
    wrapper.launches += 1
    build.check(err, f"{fn_name} launch")
    return out


def lsh_signature(key, indices: torch.Tensor, values: torch.Tensor,
                  hash_num: int) -> torch.Tensor:
    """Signed-random-projection signatures: [B, K] int32 indices and
    float32 values -> [B, ceil(H/32)] int32 (uint32 patterns).  CUDA
    tensors: one launch of K1 (csrc/lsh.cu); CPU: the plain version."""
    if indices.device.type == "cpu":
        return lsh_signature_ref(key, indices, values, hash_num)
    return _signature_launch(lsh_signature, key, indices, values, hash_num,
                             words_for(hash_num))


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
              hash_num: int, kind: str) -> torch.Tensor:
    """The kind's signature: [B, K] -> [B, sig_width] int32."""
    if kind == "minhash":
        return minhash_signature(key, indices, values, hash_num)
    return lsh_signature(key, indices, values, hash_num)


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
      euclid_lsh cos(c * f32(f32(pi) * r)), correctly rounded (XLA's
                 float32 cos is, torch's and CUDA's need not be)
    Float64 arithmetic rounded once to float32 gives the fused and the
    correctly rounded results (c * r and c * angle are exact there)."""
    top = hash_num if kind == "minhash" else 32 * words_for(hash_num)
    c = np.arange(top + 1, dtype=np.float32)
    r = np.float32(1.0) / np.float32(hash_num)
    if kind == "lsh":
        return (1.0 - c.astype(np.float64) * np.float64(r)).astype(
            np.float32)
    if kind == "minhash":
        return c * r
    ang = c * (np.float32(math.pi) * r)
    return np.cos(ang.astype(np.float64)).astype(np.float32)


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
    multiply-adds fused as XLA fuses them (in float64, rounded once)."""
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
    return -torch.sqrt(torch.clamp_min(d2, 0.0))


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


def sig_sweep_ref(kind: str, table: torch.Tensor, norms: torch.Tensor,
                  n_valid: int, q_sigs: torch.Tensor, qnorms: torch.Tensor,
                  hash_num: int) -> torch.Tensor:
    """The key of every (query, row): int64 [Nq, R] of each query
    signature (q_sigs [Nq, W], qnorms [Nq]) against the table, the rows
    from n_valid on at -inf.  The first step of sig_topk_ref."""
    r = table.shape[0]
    mask = torch.arange(r, device=table.device) < int(n_valid)
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
                 hash_num: int, kb: int) -> torch.Tensor:
    """Plain version of K3: each query's top kb keys [Nq, kb], descending
    (sig_sweep_ref, then torch.topk over its unique keys: the order is
    the keys' own, jax.lax.top_k's)."""
    keys = sig_sweep_ref(kind, table, norms, n_valid, q_sigs, qnorms,
                         hash_num)
    return torch.topk(keys, kb, dim=1, largest=True, sorted=True).values


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
             hash_num: int = 0, kb: int = 8) -> torch.Tensor:
    """Each query's top kb keys [Nq, kb] int64, descending, against table
    [R, W] (int32), norms [R] float32, of which the rows below n_valid
    are valid (the store's rows are a prefix: nothing frees a slot yet;
    the rest score -inf and fill in, the lowest rows first, where fewer
    than kb are valid).  The queries are signatures q_sigs [Nq, W] with
    qnorms [Nq], or stored rows q_rows [Nq] int64, each in [0, R) (the
    kernel gathers their signatures and norms).  1 <= kb <= R.  CUDA
    tensors: one launch of K3 (csrc/lsh.cu), with its scratch from
    torch.empty; CPU: the plain version."""
    _sig_topk_args(kind, table, n_valid, q_sigs, q_rows, kb)
    if table.device.type == "cpu":
        if q_rows is not None:
            q_sigs, qnorms = table[q_rows], norms[q_rows]
        return sig_topk_ref(kind, table, norms, int(n_valid), q_sigs,
                            qnorms, hash_num, int(kb))
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
        qr_ptr, tab.data_ptr(), r, w, nq, SIG_KINDS.index(kind), kb,
        ws.data_ptr(), ws_bytes, out.data_ptr(), stream)
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
                          qnorms, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """[Nq] datum queries: signatures (K1/K2), then the sweep with its
    selection (K3) -> (rows [Nq, k'], scores [Nq, k']) numpy, k' =
    min(_round_k(k), R); the caller trims and drops non-finite
    entries."""
    dev = table.device
    idx = _host(q_indices, np.int32, dev)
    val = _host(q_values, np.float32, dev)
    q_sigs = signature(key, idx, val, hash_num, kind)
    return keys_to_host(sig_topk(
        kind, table, norms, n_valid, q_sigs=q_sigs,
        qnorms=_host(qnorms, np.float32, dev), hash_num=hash_num,
        kb=_kb(k, table.shape[0])))


def fused_sig_query(kind: str, key, q_indices, q_values, table, norms,
                    n_valid: int, hash_num: int, qnorm: float, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One datum query -> (rows [k'], scores [k']); norms may be None
    (zeros) for the kinds that do not read them."""
    if norms is None:
        norms = torch.zeros(table.shape[0], dtype=torch.float32,
                            device=table.device)
    rows, scores = fused_sig_query_batch(
        kind, key, q_indices, q_values, table, norms, n_valid, hash_num,
        [qnorm], k)
    return rows[0], scores[0]


def fused_sig_query_row(kind: str, table: torch.Tensor, row: int,
                        norms: torch.Tensor, n_valid: int, hash_num: int,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Query by a stored row: the kernel gathers its signature and norm
    on the device (no host readback before the sweep)."""
    if not 0 <= int(row) < table.shape[0]:
        raise IndexError(f"row {row} outside the table's {table.shape[0]}")
    q_rows = torch.tensor([int(row)], dtype=torch.int64, device=table.device)
    rows, scores = keys_to_host(sig_topk(
        kind, table, norms, n_valid, q_rows=q_rows, hash_num=hash_num,
        kb=_kb(k, table.shape[0])))
    return rows[0], scores[0]


def host_signature(key, indices: np.ndarray, values: np.ndarray,
                   hash_num: int, kind: str,
                   device: Union[str, torch.device]) -> np.ndarray:
    """Signatures of a host batch computed on `device` -> uint32 numpy
    [B, sig_width]."""
    dev = torch.device(device)
    sig = signature(key, _host(indices, np.int32, dev),
                    _host(values, np.float32, dev), hash_num, kind)
    return sig.cpu().numpy().view(np.uint32)
