"""Sparse batch primitives over dense device tables (torch counterpart of
jubatus_tpu/ops/sparse.py).

A batch is (indices [B,K] int, values [B,K] f32) with zero-valued padding;
model tables are dense [L, D] (or [D]) tensors, so scoring is a gather plus
a reduction and updating is a scatter-add.  These are plain tensor ops in
both packages (XLA there, PyTorch here), not hand kernels.

XLA flushes float32 subnormals to zero (inputs read as zero, results
flush), and torch keeps them; ftz() flushes explicitly where the port
must compute as XLA does: the gathered inputs, every elementwise product
and each reduction's result.  A reduction's inner partial sums are not
flushed one by one, so a partial sum that falls into the subnormal range
can still differ in its last bits.
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


def row_scores(w: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """w: [D]; indices/values: [B, K] -> [B].  Subnormals flushed."""
    return ftz(ftz(ftz(w[indices]) * ftz(values)).sum(dim=-1))


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
