"""A reduction whose inner partial sum is subnormal (ROADMAP Queue 3 item
1): XLA flushes every partial sum on the CPU, so JAX's regression
estimate of a datum whose feature products are [1.5e-38, -1.4e-38,
2e-38] is 2e-38 (1.5e-38 - 1.4e-38 = 1e-39 flushes to 0 before 2e-38 is
added), where an unflushed sum gives 2.1e-38.  The port's estimate
(ops/sparse.row_scores through ftz_sum) reduces as XLA does and must be
bitwise JAX's, at K 16 (XLA sums in k order), K 32 (8 lanes, then a
halving tree) and K 64 and 128 (XLA's tree rewrite: windows of 32 in k
order, then their sums in order), on the repro and on random rows of
terms near the smallest normal; ftz_sum itself against those orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.models.regression import RegressionDriver as JReg
from jubatus_tpu.ops import sparse as jsparse
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.models.regression import RegressionDriver as TReg
from jubatus_tpu_torch.ops import sparse as tsparse

REPRO = [1.5e-38, -1.4e-38, 2e-38]
CFG = {"method": "PA",
       "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0},
       "converter": {"num_rules": [{"key": "*", "type": "num"}],
                     "hash_max_size": 1 << 12}}


def _estimates(prods, n_features, at):
    """Both packages' estimate of one datum of n_features numbers x = 1
    whose products w * x at the features `at` are `prods` (w set at their
    hashed columns) and 0 elsewhere."""
    names = [f"x{i}" for i in range(n_features)]
    j, t = JReg(CFG), TReg(CFG, device="cpu")
    cols = j.converter.convert_batch(
        [JDatum(num_values=[(n, 1.0) for n in names])]).indices[0]
    w = np.zeros(j.dim, np.float32)
    assert len(set(cols[list(at)].tolist())) == len(prods)
    w[cols[list(at)]] = np.asarray(prods, np.float32)
    j.w = jnp.asarray(w)
    t.w = torch.from_numpy(w.copy())
    return (j.estimate([JDatum(num_values=[(n, 1.0) for n in names])])[0],
            t.estimate([TDatum(num_values=[(n, 1.0) for n in names])])[0])


# (features, positions of the repro's terms): K 16 sums in k order; at K
# 32 the terms of one lane (k mod 8) sum in k order; at K 64 the terms
# of one window of 32 sum in k order, and the windows' sums after
@pytest.mark.parametrize("n_features, at", [(3, (0, 1, 2)), (16, (3, 9, 15)),
                                            (20, (0, 8, 16)),
                                            (32, (5, 13, 29)),
                                            (64, (3, 9, 40)),
                                            (64, (33, 47, 60))])
def test_the_repro_estimate_is_jax_s(n_features, at):
    want, got = _estimates(REPRO, n_features, at)
    assert np.float32(want) == np.float32(2e-38)
    assert np.float32(got).view(np.uint32) == np.float32(want).view(np.uint32)


def _xla_row(prods):
    k = prods.shape[-1]
    w = np.concatenate([[0.0], prods]).astype(np.float32)
    idx = np.arange(1, k + 1, dtype=np.int32)[None]
    return np.asarray(jax.jit(jsparse.row_scores)(
        jnp.asarray(w), jnp.asarray(idx), jnp.ones((1, k), jnp.float32)))[0]


@pytest.mark.parametrize("k", [8, 16, 32, 64, 128])
def test_row_scores_flush_partial_sums_as_xla(k):
    rng = np.random.default_rng(k)
    for _ in range(60):
        n = int(rng.integers(2, k + 1))
        prods = np.zeros(k, np.float32)
        pos = rng.permutation(k)[:n]
        prods[pos] = (rng.choice([-1, 1], n) * rng.uniform(1.2, 3.0, n)
                      * 1e-38).astype(np.float32)
        w = torch.from_numpy(np.concatenate([[0.0], prods]).astype(
            np.float32))
        idx = torch.arange(1, k + 1)[None]
        got = tsparse.row_scores(w, idx, torch.ones((1, k)))[0].numpy()
        assert got.view(np.uint32) == _xla_row(prods).view(np.uint32), prods


def test_ftz_sum_takes_one_sum_where_no_partial_can_be_subnormal():
    p = torch.tensor([[1.0, -1.0, 2.0 ** -100, 3.0]])
    assert torch.equal(tsparse.ftz_sum(p), tsparse.ftz(p.sum(-1)))
    zeros = torch.tensor([[-0.0, -0.0]])
    assert tsparse.ftz_sum(zeros).item() == 0.0
