"""Sparse batch primitives over dense device tables (torch counterpart of
jubatus_tpu/ops/sparse.py).

A batch is (indices [B,K] int, values [B,K] f32) with zero-valued padding;
model tables are dense [L, D] (or [D]) tensors, so scoring is a gather plus
a reduction and updating is a scatter-add.  These are plain tensor ops in
both packages (XLA there, PyTorch here), not hand kernels.

XLA flushes float32 subnormals to zero (inputs read as zero, results
flush), and torch keeps them; ftz() flushes explicitly where the port
must compute as XLA does: the gathered inputs, every elementwise product
and each reduction's result.  On the CPU, row_scores (estimate) also
flushes its reduction's partial sums in XLA's CPU order (ftz_sum) for K
up to 32; the other reductions, and every reduction on the card (torch's
CUDA sum has its own tree order), flush only their result, so a partial
sum that falls into the subnormal range can still differ in its last
bits there.
"""

from __future__ import annotations

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
    (value 0) contribute nothing.  Subnormals flushed (ftz)."""
    g = ftz(w[:, indices])                     # [L, B, K]
    return ftz(ftz(g * ftz(values)).sum(dim=-1).T)


# below this magnitude a nonzero term can leave a partial sum subnormal:
# every float32 of at least 2^-103 is a multiple of 2^-126, the smallest
# normal, and so is every rounded partial sum of such terms
_PARTIAL_SAFE = 2.0 ** -103


def _seq_sum(p: torch.Tensor) -> torch.Tensor:
    """p.sum(-1) in k order from +0, every partial sum flushed."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for j in range(p.shape[-1]):
        acc = ftz(acc + p[..., j])
    return acc


def ftz_sum(p: torch.Tensor) -> torch.Tensor:
    """p.sum(-1) of flushed terms as XLA's CPU code reduces a row of K
    float32 terms under flush-to-zero, every partial sum flushed:
    sequentially in k from +0 for K <= 16; in 8 lanes (k mod 8) from +0,
    then a halving tree over the lanes, for K = 32; above 32, where XLA
    rewrites the reduce as a tree, in windows of 32 (each in k order from
    +0) until at most 32 sums are left, then those in order from +0, for
    K a multiple of 32 (every converter width is).  tests/
    test_torch_partial_sums.py pins the three.  A partial sum can only be
    subnormal where some nonzero term lies below 2^-103, so otherwise,
    and for a K above 32 that is no multiple of 32, it is one sum with
    its result flushed.  So is every sum of a tensor on the card: the
    check would read a bool back on the estimate's path, and torch's CUDA
    reduction does not sum in XLA's CPU order anyway."""
    k = p.shape[-1]
    if p.device.type != "cpu" or (k > 32 and k % 32) or not bool(
            ((p != 0) & (p.abs() < _PARTIAL_SAFE)).any()):
        return ftz(p.sum(dim=-1))
    if k <= 16:
        return _seq_sum(p)
    if k > 32:
        while p.shape[-1] > 32:
            n = p.shape[-1]
            p = _seq_sum(p.reshape(*p.shape[:-1], n // 32, 32))
        return _seq_sum(p)
    lanes = p.reshape(*p.shape[:-1], k // 8, 8)
    acc = torch.zeros(lanes.shape[:-2] + (8,), dtype=p.dtype,
                      device=p.device)
    for j in range(k // 8):
        acc = ftz(acc + lanes[..., j, :])
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = ftz(acc[..., :h] + acc[..., h:])
    return acc[..., 0]


def row_scores(w: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """w: [D]; indices/values: [B, K] -> [B].  Subnormals flushed, on the
    CPU the reduction's partial sums too (ftz_sum)."""
    return ftz_sum(ftz(ftz(w[indices]) * ftz(values)))


def sample_scores(w: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """w: [L, D]; idx/val: [K] -> [L]  (single-sample gather-dot).
    Subnormals flushed."""
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
