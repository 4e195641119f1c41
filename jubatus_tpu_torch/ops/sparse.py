"""Sparse batch primitives over dense device tables (torch counterpart of
jubatus_tpu/ops/sparse.py).

A batch is (indices [B,K] int, values [B,K] f32) with zero-valued padding;
model tables are dense [L, D] (or [D]) tensors, so scoring is a gather plus
a reduction and updating is a scatter-add.  These are plain tensor ops in
both packages (XLA there, PyTorch here), not hand kernels.

XLA flushes float32 subnormals to zero (inputs read as zero, results
flush), and torch keeps them; ftz() flushes explicitly where the port
must compute as XLA does.  On the CPU the gather-dots (row_scores for
the estimate, batch_scores for classify, sample_scores) sum as XLA's CPU
code does, in its order and with its fused multiply-adds (xla_dot_rows),
so they are bitwise the JAX package's.  On the card each is one torch
CUDA sum of the flushed products with its result flushed: torch's CUDA
reduction has its own order, and the card is held to the tolerance its
tests state.
"""

from __future__ import annotations

import math

import torch

# the largest float32 subnormal, 2^-126 - 2^-149 (exact in float32)
_SUBNORMAL_MAX = torch.finfo(torch.float32).tiny * (1 - 2.0 ** -23)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with float32 subnormals flushed to a zero of the same sign, as
    x86's flush-to-zero mode (and XLA) gives them; NaN and inf stay.  Two
    elementwise ops, so two small launches on the card: hardshrink zeroes
    every |x| <= _SUBNORMAL_MAX (to +0) and passes the rest, NaN too;
    copysign gives each zero x's sign back."""
    return torch.copysign(torch.nn.functional.hardshrink(x, _SUBNORMAL_MAX),
                          x)


def batch_scores(w: torch.Tensor, indices: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """w: [L, D]; indices/values: [B, K] -> [B, L].  Padding entries
    (value 0) contribute nothing.  On the CPU XLA's order of the einsum
    (xla_dot_rows: "dot1" at B 1, "gemv" above); on the card one torch sum,
    subnormals flushed (ftz)."""
    g = w[:, indices]                          # [L, B, K]
    if w.device.type == "cpu":
        form = "dot1" if indices.shape[0] == 1 else "gemv"
        return xla_dot_rows(g, values, form).T
    return ftz(ftz(ftz(g) * ftz(values)).sum(dim=-1).T)


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as x86's vfmadd gives it (and
    CUDA's fmaf).  The product is exact in float64; the sum is rounded to
    odd there (TwoSum's error decides), so the one rounding to float32 is
    the only one that counts."""
    p = a.double() * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.float()


# XLA's CPU code for a row of K products (K the last axis), read off its
# dumps (--xla_dump_to, objdump -d of the object files: LLVM fuses a
# multiply into the add that takes it where the multiply has no other
# use).  Each form names the JAX expression that compiles to it:
#   "sum"   jnp.sum(a * b, -1): the regression estimate (row_scores) and
#           anomaly's _chunk_dots.  K <= 16: a chain of fused multiply-
#           adds in k order from +0; K 32: 8 such chains (k mod 8), then
#           a halving tree; K above 32, a multiple of 32: XLA's tree
#           rewrite, windows of 32 products (each rounded, then added in
#           k order from +0) until at most 32 sums are left, then those
#           in order from +0;
#   "dot1"  the dot of one datum (classify at B 1, sample_scores):
#           K <= 16 and K 32 as "sum"; K above 32, a multiple of 32: 32
#           chains (k mod 32) of fused multiply-adds, then the four
#           vectors of 8 added as v0 + v1, then + v2, then + v3, then a
#           halving tree;
#   "gemv"  a batched dot of B > 1 datums (classify's einsum over a
#           [L, B, K] gather, L labels on the first axis): one fused chain
#           in k order, from +0 for the labels that XLA's loop takes 8 at
#           a time (l < 8 * (L // 8)) and from -0 for the rest (its scalar
#           remainder: read at L 5 and 13; a served classify has none, as
#           both packages' label capacities start at 8 and double);
#   "einsum" jnp.einsum("rk,rk->r"), _fused_dense_query's elemental dot:
#           k order, starting from the first product, the first 8
#           products rounded and added, the rest fused.
# The zero signs are those of the jitted programs (_estimate,
# _chunk_dots, _classify_scores, sample_scores): a fused step whose exact
# result is a negative subnormal flushes to -0, and -0 + +0 is +0.  The
# chains of a vectorized loop (8 or 32 lanes) start as LLVM's vectorized
# reduction starts them, the start value +0 in lane 0 and fadd's identity
# -0 in the others, so a row of -0 products sums to -0 unless lane 0 ends
# at +0; the gemv's remainder labels start from -0, so a row whose every
# product is -0 gives -0 there.  These are read at the converter's K
# buckets (16 and up); below K 16, where XLA unrolls the loops otherwise
# and no jitted read of either package runs, "dot1" and "gemv" give +0
# for every zero, as the eager einsum does.
# Every input is read with DAZ and every partial result flushed (ftz).
XLA_DOT_FORMS = ("sum", "dot1", "gemv", "einsum")


def _chain(a, b, acc, fused: bool):
    for j in range(a.shape[-1]):
        acc = ftz(fma(a[..., j], b[..., j], acc) if fused
                  else acc + ftz(a[..., j] * b[..., j]))
    return acc


def _lanes(a, b, n: int):
    """n fused chains (k mod n), lane 0 from +0 and the rest from -0 ->
    [..., n]."""
    k = a.shape[-1]
    aa = a.reshape(*a.shape[:-1], k // n, n)
    bb = b.reshape(*b.shape[:-1], k // n, n)
    acc = torch.zeros(aa.shape[:-2] + (n,), dtype=torch.float32,
                      device=a.device)
    acc[..., 1:] = -0.0
    for j in range(k // n):
        acc = ftz(fma(aa[..., j, :], bb[..., j, :], acc))
    return acc


def _halve(acc):
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = ftz(acc[..., :h] + acc[..., h:])
    return acc[..., 0]


def _in_order(parts):
    acc = torch.zeros(parts.shape[:-1], dtype=torch.float32,
                      device=parts.device)
    for j in range(parts.shape[-1]):
        acc = ftz(acc + parts[..., j])
    return acc


def xla_dot_rows(a: torch.Tensor, b: torch.Tensor,
                 form: str = "sum") -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] of float32 tensors as XLA's CPU code
    computes the JAX expression of `form` (XLA_DOT_FORMS above), bit for
    bit at every K of "gemv" and "einsum" and at K <= 16 or a multiple of
    32 of the others, zero signs included at K 16 and up ("dot1" and
    "gemv" give every zero as +0 below K 16); elsewhere one torch sum of
    the flushed products, its result flushed.  An emulation in float64
    steps, one small op a column: the reads call it for CPU tensors only
    (the card's kernels and sums have their own), and it gives the same
    bits on the card, where the plain versions of K4 run it."""
    a, b = torch.broadcast_tensors(ftz(a.float()), ftz(b.float()))
    k = a.shape[-1]
    zero = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    if k == 0:
        return zero
    if form == "einsum":
        first = min(k, 8)
        acc = _chain(a[..., 1:first], b[..., 1:first],
                     ftz(a[..., 0] * b[..., 0]), fused=False)
        return _chain(a[..., first:], b[..., first:], acc, fused=True)
    if form not in XLA_DOT_FORMS:
        raise ValueError(f"unknown dot form {form!r}")
    out = _dot_rows(a, b, form, zero)
    # below the converter's smallest K bucket no jitted read runs: +0 for
    # every zero there, as the eager einsum gives it
    return out + 0.0 if form in ("dot1", "gemv") and k < 16 else out


def _dot_rows(a, b, form: str, zero):
    k = a.shape[-1]
    if form == "gemv":
        start = zero.clone()
        start[8 * (a.shape[0] // 8):] = -0.0
        return _chain(a, b, start, fused=True)
    if k <= 16:
        return _chain(a, b, zero, fused=True)
    if k % 32:
        return ftz(ftz(a * b).sum(-1))
    if k == 32:
        return _halve(_lanes(a, b, 8))
    if form == "dot1":
        v = _lanes(a, b, 32)
        s = ftz(v[..., 8:16] + v[..., :8])
        s = ftz(v[..., 16:24] + s)
        return _halve(ftz(v[..., 24:] + s))
    p = ftz(a * b)
    while p.shape[-1] > 32:
        n = p.shape[-1]
        p = _in_order(p.reshape(*p.shape[:-1], n // 32, 32))
    return _in_order(p)


def row_scores(w: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """w: [D]; indices/values: [B, K] -> [B].  On the CPU bitwise XLA's
    jnp.sum(w[indices] * values, -1) (xla_dot_rows); on the card one torch
    CUDA sum of the flushed products, its result flushed (torch's CUDA
    reduction has its own tree order, so the card is held to the stated
    tolerance, not to the bits)."""
    if w.device.type == "cpu":
        return xla_dot_rows(w[indices], values)
    return ftz(ftz(ftz(w[indices]) * ftz(values)).sum(dim=-1))


def sample_scores(w: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """w: [L, D]; idx/val: [K] -> [L]  (single-sample gather-dot).  On
    the CPU XLA's order of one datum's dot (xla_dot_rows "dot1"); on the
    card one torch sum, subnormals flushed."""
    if w.device.type == "cpu":
        return xla_dot_rows(w[:, idx], val, "dot1")
    return ftz(ftz(ftz(w[:, idx]) * ftz(val)).sum(dim=-1))


def scatter_add_row(w: torch.Tensor, row: int, idx: torch.Tensor,
                    upd: torch.Tensor) -> torch.Tensor:
    """w[row, idx[k]] += upd[k] in place (duplicates accumulate)."""
    w[row].index_add_(0, idx, upd)
    return w


def densify(indices: torch.Tensor, values: torch.Tensor,
            dim: int) -> torch.Tensor:
    """[B,K] sparse -> [B,dim] dense (duplicates accumulate)."""
    b = indices.shape[0]
    out = torch.zeros((b, dim), dtype=values.dtype, device=values.device)
    rows = torch.arange(b, device=indices.device)[:, None].expand_as(indices)
    return out.index_put_((rows, indices.long()), values, accumulate=True)
