"""A reduction whose inner partial sum is subnormal (ROADMAP Queue 3 item
1): XLA flushes every partial sum on the CPU, so JAX's regression
estimate of a datum whose feature products are [1.5e-38, -1.4e-38,
2e-38] is 2e-38 (1.5e-38 - 1.4e-38 = 1e-39 flushes to 0 before 2e-38 is
added), where an unflushed sum gives 2.1e-38.  The port's estimate
(ops/sparse.row_scores through xla_dot_rows) reduces as XLA does and must be
bitwise JAX's, at K 16 (XLA sums in k order), K 32 (8 lanes, then a
halving tree) and K 64 and 128 (XLA's tree rewrite: windows of 32 in k
order, then their sums in order), on the repro and on random rows of
terms near the smallest normal.  The same reads over seeded standard-
normal rows, where XLA's fused multiply-adds decide the bits: the
estimate, classify's scores at one datum and at eight, sample_scores and
the einsum of the exact sweep (ops/sparse.xla_dot_rows)."""

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


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _zero_rows(rng, n, k):
    """Rows a, b [n >= 6, k] whose products are all -0 (a 0 against a
    negative value, a -0 against a positive one), all flush to zero
    (subnormal products, all negative or of both signs), a mix of -0 and
    tiny negative products, and normal rows after them."""
    a = rng.standard_normal((n, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    a[0], b[0] = 0.0, -1.0
    a[1], b[1] = -0.0, np.abs(b[1])
    a[2] = rng.uniform(1e-25, 1e-20, k).astype(np.float32)
    b[2] = -rng.uniform(1e-25, 1e-20, k).astype(np.float32)
    a[3] = rng.uniform(1e-25, 1e-20, k).astype(np.float32)
    b[3] = (rng.choice([-1, 1], k) * rng.uniform(1e-25, 1e-20, k)).astype(
        np.float32)
    a[4, ::2], b[4, ::2] = 0.0, -1.0
    a[4, 1::2], b[4, 1::2] = np.float32(1e-22), np.float32(-1e-22)
    return a, b


@pytest.mark.parametrize("k", [16, 32, 64])
def test_sum_of_products_that_all_flush_keeps_xla_s_zero(k):
    """The "sum" form against the JAX functions it stands for, jitted (the
    estimate's jnp.sum(w[idx] * v, -1) and anomaly's _chunk_dots), on rows
    whose products are all -0 or all flush to zero: a fused step whose
    exact result is a negative subnormal flushes to -0 (K 16 and 32), the
    windows of K 64 sum rounded products from +0, and -0 products from a
    +0 start give +0."""
    from jubatus_tpu.models.anomaly import _chunk_dots
    from jubatus_tpu.models.regression import _estimate
    n = 8
    a, b = _zero_rows(np.random.default_rng(500 + k), n, k)
    w = a.reshape(-1)
    idx = np.arange(n * k, dtype=np.int32).reshape(n, k)
    got = tsparse.xla_dot_rows(torch.from_numpy(a), torch.from_numpy(b),
                               "sum").numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(_estimate(w, idx, b))))
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(_chunk_dots(idx, b, w[None]))[0]))
    assert (_bits(got)[:2] == 0).all()
    assert (_bits(got)[2] == 0x80000000) == (k <= 32)


# the estimate over seeded standard-normal rows, where XLA's fused
# multiply-adds and its order decide the last bits of most rows (a torch
# sum of the products differs from _estimate on 65-73% of them)
@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_estimate_is_bitwise_jax_on_normal_rows(k):
    from jubatus_tpu.models.regression import _estimate
    rng = np.random.default_rng(100 + k)
    d, n = 4096, 1024
    w = rng.standard_normal(d).astype(np.float32)
    idx = rng.integers(0, d, (n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(np.float32)
    want = np.asarray(_estimate(jnp.asarray(w), jnp.asarray(idx),
                                jnp.asarray(val)))
    got = tsparse.row_scores(torch.from_numpy(w), torch.from_numpy(idx).long(),
                             torch.from_numpy(val)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("b", [1, 8])
def test_classify_scores_are_bitwise_jax_on_normal_rows(b, k):
    """batch_scores against the JAX package's jitted _classify_scores
    (all labels active): XLA's one-datum dot at B 1, its k-order gemv
    above."""
    from jubatus_tpu.models.classifier import _classify_scores
    rng = np.random.default_rng(200 + k + b)
    d, nl = 4096, 16
    w = rng.standard_normal((nl, d)).astype(np.float32)
    for _ in range(4):
        idx = rng.integers(0, d, (b, k)).astype(np.int32)
        val = rng.standard_normal((b, k)).astype(np.float32)
        want = np.asarray(_classify_scores(
            jnp.asarray(w), jnp.ones(nl, bool), jnp.asarray(idx),
            jnp.asarray(val)))
        got = tsparse.batch_scores(torch.from_numpy(w),
                                   torch.from_numpy(idx).long(),
                                   torch.from_numpy(val)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_sample_scores_are_bitwise_jax_on_normal_rows(k):
    rng = np.random.default_rng(300 + k)
    d, nl = 4096, 64
    w = rng.standard_normal((nl, d)).astype(np.float32)
    fn = jax.jit(jsparse.sample_scores)
    for _ in range(8):
        idx = rng.integers(0, d, k).astype(np.int32)
        val = rng.standard_normal(k).astype(np.float32)
        want = np.asarray(fn(jnp.asarray(w), jnp.asarray(idx),
                             jnp.asarray(val)))
        got = tsparse.sample_scores(torch.from_numpy(w),
                                    torch.from_numpy(idx).long(),
                                    torch.from_numpy(val)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_einsum_form_is_xla_s_elemental_dot(k):
    """The "einsum" form against jnp.einsum("rk,rk->r") jitted, the dot of
    _fused_dense_query: k order from the first product, the first 8
    products unfused; a row whose products are all -0 sums to -0."""
    rng = np.random.default_rng(400 + k)
    a = rng.standard_normal((512, k)).astype(np.float32)
    b = rng.standard_normal((512, k)).astype(np.float32)
    a[7] = 0.0
    b[7] = -1.0
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum("rk,rk->r", x, y))(
        jnp.asarray(a), jnp.asarray(b)))
    got = tsparse.xla_dot_rows(torch.from_numpy(a), torch.from_numpy(b),
                               "einsum").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got)[7] == 0x80000000


# the zero signs of the jitted reads (ROADMAP Queue 3 item 1): a vectorized
# loop's lanes start at +0 (lane 0) and -0 (the others), the batched dot's
# chains at +0 for the labels its loop takes 8 at a time and at -0 for the
# rest, and a fused step whose exact result is a negative subnormal flushes
# to -0.  13 labels: the first 8 one group of the batched dot, the last 5
# its remainder; the served label capacities (8, 16, ...) have none.
ZERO_SIGN_ROWS = ("normal", "zero", "neg_zero", "tiny_neg", "tiny_mixed",
                  "neg_zero_then_tiny", "tiny_at_0", "tiny_at_1",
                  "pos_zero_then_tiny_last", "neg_zero", "zero", "tiny_at_0",
                  "normal")


def _zero_sign_table(rng, b, k, labels=ZERO_SIGN_ROWS):
    """A label table w [L, D] and a batch idx / val [b, k] on columns of
    their own, so that label l's products w[l, idx[i]] * val[i] are, by
    labels[l]: +-0 by val's sign; all -0; all negative subnormals
    (|w| near the smallest normal, |val| < 0.5); subnormals of both signs;
    -0 then negative subnormals; -0 but for a negative subnormal at k 0, or
    at k 1; +0 but for a negative subnormal at the last k; normal."""
    idx = (1 + rng.permutation(b * k)).astype(np.int32).reshape(b, k)
    val = (rng.choice([-1.0, 1.0], (b, k))
           * rng.uniform(0.05, 0.5, (b, k))).astype(np.float32)
    sgn = np.sign(val)
    tiny = rng.uniform(1.2e-38, 2.0e-38, (b, k)).astype(np.float32)
    rows = {
        "zero": np.zeros((b, k), np.float32),
        "neg_zero": np.copysign(0.0, -sgn),
        "tiny_neg": -sgn * tiny,
        "tiny_mixed": rng.choice([-1.0, 1.0], (b, k)) * tiny,
        "normal": rng.standard_normal((b, k)),
    }
    half = np.copysign(0.0, -sgn)
    half[:, k // 2:] = (-sgn * tiny)[:, k // 2:]
    rows["neg_zero_then_tiny"] = half
    for name, at in (("tiny_at_0", 0), ("tiny_at_1", 1)):
        r = np.copysign(0.0, -sgn)
        r[:, at] = -sgn[:, at] * tiny[:, at]
        rows[name] = r
    r = np.copysign(0.0, sgn)
    r[:, -1] = -sgn[:, -1] * tiny[:, -1]
    rows["pos_zero_then_tiny_last"] = r
    w = np.zeros((len(labels), b * k + 1), np.float32)
    for l, name in enumerate(labels):
        w[l, idx] = rows[name] if name != "normal" else \
            rng.standard_normal((b, k))
    return w, idx, val


def _assert_zero_signs(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))
    z = np.asarray(want).reshape(-1) == 0
    signs = np.signbit(np.asarray(want).reshape(-1)[z])
    assert signs.any() and not signs.all()   # both zeros are in the band


@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("b", [1, 8, 32, 128])
@pytest.mark.parametrize("n_labels", [8, 13, 16])
def test_classify_scores_keep_the_jitted_zero_sign(n_labels, b, k):
    """batch_scores against the jitted _classify_scores (its one-datum dot
    at B 1, its gemv above; B 8 to 128 as the server pads a classify) on
    rows of -0 products, of negative subnormal products and of both,
    beside normal rows: at 8 and 16 labels (served capacities, the gemv's
    loop of 8 only) and at 13 (5 in its remainder)."""
    from jubatus_tpu.models.classifier import _classify_scores
    labels = (ZERO_SIGN_ROWS * 2)[:n_labels]
    w, idx, val = _zero_sign_table(
        np.random.default_rng(600 + k + b + n_labels), b, k, labels)
    want = np.asarray(_classify_scores(
        jnp.asarray(w), jnp.ones(w.shape[0], bool), jnp.asarray(idx),
        jnp.asarray(val)))
    got = tsparse.batch_scores(torch.from_numpy(w),
                               torch.from_numpy(idx).long(),
                               torch.from_numpy(val)).numpy()
    _assert_zero_signs(got, want)


@jax.jit
def _scanned_sample_scores(w, idx, val):
    """sample_scores as train_scan_impl runs it: in the body of a jitted
    lax.scan over the datums."""
    def body(carry, xs):
        return carry, jsparse.sample_scores(w, xs[0], xs[1])
    return jax.lax.scan(body, 0, (idx, val))[1]


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_sample_scores_keep_the_jitted_zero_sign(k):
    """sample_scores against jsparse.sample_scores jitted alone and in a
    jitted scan, datum by datum, on the rows of _zero_sign_table."""
    w, idx, val = _zero_sign_table(np.random.default_rng(700 + k), 4, k)
    scanned = np.asarray(_scanned_sample_scores(
        jnp.asarray(w), jnp.asarray(idx), jnp.asarray(val)))
    alone = jax.jit(jsparse.sample_scores)
    got = np.stack([tsparse.sample_scores(
        torch.from_numpy(w), torch.from_numpy(idx[i]).long(),
        torch.from_numpy(val[i])).numpy() for i in range(4)])
    want = np.stack([np.asarray(alone(jnp.asarray(w), jnp.asarray(idx[i]),
                                      jnp.asarray(val[i])))
                     for i in range(4)])
    _assert_zero_signs(got, want)
    np.testing.assert_array_equal(_bits(got), _bits(scanned))


@pytest.mark.parametrize("k", [16, 32, 64, 128])
def test_sum_keeps_the_jitted_zero_sign(k):
    """The "sum" form against the jitted estimate and _chunk_dots on the
    same rows: at K 32 the 8 lanes start at +0 and -0, so a row of -0
    products with a negative subnormal at k 0 sums to -0."""
    from jubatus_tpu.models.anomaly import _chunk_dots
    from jubatus_tpu.models.regression import _estimate
    w, idx, val = _zero_sign_table(np.random.default_rng(800 + k), 1, k)
    a = np.ascontiguousarray(w[:, idx[0]])           # [L, k]
    b = np.broadcast_to(val, a.shape).copy()
    rows = np.arange(a.size, dtype=np.int32).reshape(a.shape)
    got = tsparse.xla_dot_rows(torch.from_numpy(a), torch.from_numpy(b),
                               "sum").numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(_estimate(a.reshape(-1), rows, b))))
    np.testing.assert_array_equal(
        _bits(got),
        _bits(np.asarray(_chunk_dots(rows, b, a.reshape(1, -1)))[0]))
    lane0 = ZERO_SIGN_ROWS.index("tiny_at_0")
    assert np.signbit(got[lane0]) == (k <= 32)
