"""Sparse batch primitives over dense device tables (torch counterpart of
jubatus_tpu/ops/sparse.py).

A batch is (indices [B,K] int, values [B,K] f32) with zero-valued padding;
model tables are dense [L, D] (or [D]) tensors, so scoring is a gather plus
a reduction and updating is a scatter-add.  These are plain tensor ops in
both packages (XLA there, PyTorch here), not hand kernels.
"""

from __future__ import annotations

import torch


def batch_scores(w: torch.Tensor, indices: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """w: [L, D]; indices/values: [B, K] -> [B, L].  Padding entries
    (value 0) contribute nothing."""
    g = w[:, indices]                          # [L, B, K]
    return torch.einsum("lbk,bk->bl", g, values)


def row_scores(w: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """w: [D]; indices/values: [B, K] -> [B]."""
    return (w[indices] * values).sum(dim=-1)


def sample_scores(w: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """w: [L, D]; idx/val: [K] -> [L]  (single-sample gather-dot)."""
    return w[:, idx] @ val


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
