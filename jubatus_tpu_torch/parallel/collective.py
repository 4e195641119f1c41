"""The collective MIX fold of stacked replicas (counterpart of
jubatus_tpu/parallel/collective.py).

The JAX package reconciles the replicas of one mesh with ONE XLA program
(make_tree_mix, a shard_map over dp): for every leaf of the model tree,

  float leaves -> base + reduce(leaf - base) / ndp   (the averaged delta)
  int   leaves -> base + psum(leaf - base)           (exact count fold)
  bool  leaves -> psum(int32(leaf)) > 0              (any-reduce: actives)

where `reduce` is the exact f32 psum (payload "f32") or the blockwise int8
ring (payload "int8", parallel/quantized.py).  Here every leaf is a
stacked [ndp, ...] tensor on one device, so psum is a sum along axis 0 in
rank order (XLA's CPU all-reduce order: x0 + x1 + ... + x_{n-1}), and the
int8 ring is ring_all_reduce_int8 over the ranks, its hops device copies
and each hop's quantizer one launch (csrc/quantize.cu).  ndp divides as an
f32 value, as JAX's psum of ones does.  Each output leaf is a new tensor
holding every replica's folded value; the caller rebinds the state to it
and takes its base as a copy (the port's scans update state in place).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from jubatus_tpu_torch.parallel.quantized import (rank_sum as _psum,
                                                  ring_all_reduce_int8)


def make_reduce_delta(payload: str, n_static: int
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The delta reduction: the exact f32 sum or the int8 ring."""
    if payload == "int8":
        return ring_all_reduce_int8
    if payload == "f32":
        return _psum
    raise ValueError(f"unknown mix payload: {payload}")


def _mix_leaf(x: torch.Tensor, base: torch.Tensor,
              reduce_delta) -> torch.Tensor:
    """One leaf of the fold; its dtype picks the reduction.  Integer
    counts and boolean masks always fold exactly."""
    if x.dtype == torch.bool:
        return _psum(x.to(torch.int32)) > 0
    if not x.dtype.is_floating_point:
        return base + _psum(x - base)
    ndp = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    return base + reduce_delta(x - base) / ndp


def make_tree_mix(ndp: int, payload: str = "f32"):
    """mix(state, base) -> folded tree, for dicts of stacked [ndp, ...]
    leaves of the same keys.  A bool leaf may pass itself as its base; the
    bool fold never reads it."""
    reduce_delta = make_reduce_delta(payload, ndp)

    def mix(state: Dict[str, torch.Tensor],
            base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: _mix_leaf(v, base[k], reduce_delta)
                for k, v in state.items()}

    return mix
