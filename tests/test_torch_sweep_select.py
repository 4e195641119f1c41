"""The port's sweep with its top-k selection (jubatus_tpu_torch/ops/lsh.py
sig_topk, here its plain version on the CPU: sig_sweep_ref, then
torch.topk over the unique keys) against the JAX package's fused query
routes (jubatus_tpu/ops/lsh.py _fused_sig_query, _fused_sig_query_row and
_fused_sig_query_batch, through fused_sig_query*), on seeded numpy tables.

Covered: kb of 8, 16, 64 and 1024 (the _round_k buckets of the sizes
asked); fewer valid rows than kb (the invalid rows fill in, the lowest
first, as jax.lax.top_k places them) and a count of 0 (all fillers); a
table of identical signatures (the top is pure row order); 1, 13, 64 and
65 queries in one batch; validity as a bool mask with holes (the
recommender's store after drops), by datum and in a batch.

Tolerances: lsh and minhash rows and scores bitwise; euclid_lsh scores
within 1 ulp (the plain version's float64 steps round as XLA's fused
float32 ones but for the last bit), its rows equal except where JAX's
scores of the rows swapped lie within that ulp.
"""

import jax
import numpy as np
import pytest
import torch

from jubatus_tpu.ops import lsh as jlsh
from jubatus_tpu_torch.ops import lsh as tlsh

SEED = 0x1EAF
JKEY = jax.random.key(SEED)
TKEY = tlsh.prng_key(SEED)
KINDS = ("lsh", "minhash", "euclid_lsh")
H = 64
ROWS = 1200
# a size asked for each kb bucket: _round_k(k) = 8, 16, 64, 1024
K_FOR_KB = {8: 5, 16: 10, 64: 40, 1024: 700}


def datums(rows, seed, features=24):
    """Datums of two features of `features` names: many rows share a
    signature, so scores tie."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, features, (rows, 2)).astype(np.int32)
    val = rng.choice(np.array([-1.0, 0.5, 2.0], np.float32), (rows, 2))
    return idx, val


def table(kind, idx, val):
    sig = np.asarray(jlsh.signature(JKEY, idx, val, H, kind))
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return sig, norms, (torch.from_numpy(sig.view(np.int32).copy()),
                        torch.from_numpy(norms.copy()))


def ulps(a, b):
    """|a - b| in float32 ulps, for finite values of one sign."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def assert_top(kind, want, got):
    (wr, ws), (gr, gs) = (tuple(map(np.asarray, x)) for x in (want, got))
    assert wr.shape == gr.shape and ws.shape == gs.shape
    if kind != "euclid_lsh":
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
        return
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gs[~fin], ws[~fin])
    assert (ulps(gs[fin], ws[fin]) <= 1).all()
    for i in np.nonzero(gr != wr)[0]:
        # a swap only between rows whose JAX scores lie within 1 ulp
        j = np.nonzero(wr == gr[i])[0]
        assert j.size and ulps(ws[j[:1]], ws[i:i + 1])[0] <= 1, (i, wr, gr)


def valid_counts(kb):
    """Every row valid but 3, fewer valid rows than kb, and none."""
    return (ROWS - 3, max(kb // 2, 1), 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kb", [8, 16, 64, 1024])
@pytest.mark.parametrize("case", [0, 1, 2])
def test_topk_by_datum_against_jax(kind, kb, case):
    idx, val = datums(ROWS, 3)
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    valid = valid_counts(kb)[case]
    q_idx, q_val = idx[9:10], val[9:10] * np.float32(1.5)
    qnorm = float(np.sqrt((q_val * q_val).sum()))
    k = K_FOR_KB[kb]
    want = jlsh.fused_sig_query(kind, JKEY, q_idx, q_val, sig, norms, valid,
                                H, qnorm, k)
    got = tlsh.fused_sig_query(kind, TKEY, q_idx, q_val, t_sig, t_norms,
                               valid, H, qnorm, k)
    assert np.asarray(got[0]).shape == (kb,)
    assert_top(kind, want, got)
    if valid < kb:
        # the fillers: the lowest invalid rows, in order, at -inf
        rows, scores = (np.asarray(x) for x in got)
        np.testing.assert_array_equal(rows[valid:], np.arange(valid, kb))
        assert np.all(scores[valid:] == -np.inf)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kb", [8, 16, 64, 1024])
def test_topk_by_row_against_jax(kind, kb):
    idx, val = datums(ROWS, 4)
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    k = K_FOR_KB[kb]
    for row, valid in ((0, ROWS), (17, ROWS - 40), (1199, kb // 2)):
        want = jlsh.fused_sig_query_row(kind, sig, row, norms, valid, H, k)
        got = tlsh.fused_sig_query_row(kind, t_sig, row, t_norms, valid, H,
                                       k)
        assert_top(kind, want, got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nq", [1, 13, 64, 65])
def test_topk_batch_against_jax(kind, nq):
    idx, val = datums(ROWS, 5)
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    q_idx, q_val = datums(nq, 50 + nq)
    q_val = q_val * np.float32(-0.75)
    qnorms = np.sqrt((q_val * q_val).sum(1)).astype(np.float32)
    valid = ROWS - 7
    want = jlsh.fused_sig_query_batch(kind, JKEY, q_idx, q_val, sig, norms,
                                      valid, H, qnorms, 10)
    got = tlsh.fused_sig_query_batch(kind, TKEY, q_idx, q_val, t_sig,
                                     t_norms, valid, H, qnorms, 10)
    assert np.asarray(got[0]).shape == (nq, 16)
    for i in range(nq):
        assert_top(kind, (want[0][i], want[1][i]), (got[0][i], got[1][i]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ["datum", "row", "batch"])
def test_topk_identical_signatures_is_row_order(kind, route):
    """Every row holds one datum's signature: every score ties, so the top
    is rows 0..kb-1 in order, past the count the fillers."""
    idx = np.tile(np.array([[3, 7]], np.int32), (300, 1))
    val = np.tile(np.array([[0.5, -1.0]], np.float32), (300, 1))
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    qnorm = float(norms[0])
    for valid in (300, 290, 20):
        if route == "datum":
            want = jlsh.fused_sig_query(kind, JKEY, idx[:1], val[:1], sig,
                                        norms, valid, H, qnorm, 40)
            got = tlsh.fused_sig_query(kind, TKEY, idx[:1], val[:1], t_sig,
                                       t_norms, valid, H, qnorm, 40)
        elif route == "row":
            want = jlsh.fused_sig_query_row(kind, sig, 5, norms, valid, H,
                                            40)
            got = tlsh.fused_sig_query_row(kind, t_sig, 5, t_norms, valid,
                                           H, 40)
        else:
            want = jlsh.fused_sig_query_batch(
                kind, JKEY, idx[:3], val[:3], sig, norms, valid, H,
                norms[:3], 40)
            got = tlsh.fused_sig_query_batch(
                kind, TKEY, idx[:3], val[:3], t_sig, t_norms, valid, H,
                norms[:3], 40)
            want, got = (want[0][2], want[1][2]), (got[0][2], got[1][2])
        assert_top(kind, want, got)
        np.testing.assert_array_equal(np.asarray(got[0]), np.arange(64))


def holes(seed, n_valid_rows=None, keep=0.6):
    """A bool validity mask of ROWS with holes (the recommender's store
    after drops), or of only n_valid_rows rows set."""
    rng = np.random.default_rng(seed)
    m = rng.random(ROWS) < keep
    if n_valid_rows is not None:
        m[:] = False
        m[rng.choice(ROWS, n_valid_rows, replace=False)] = True
    return m


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kb", [8, 64, 1024])
@pytest.mark.parametrize("case", ["holes", "fewer_than_kb", "none"])
def test_masked_topk_by_datum_against_jax(kind, kb, case):
    """The recommender's route: a bool mask with holes (the rows it
    leaves out at -inf, filling in in lax.top_k's order, lowest first)."""
    idx, val = datums(ROWS, 6)
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    mask = {"holes": holes(1), "fewer_than_kb": holes(2, max(kb // 3, 1)),
            "none": holes(3, 0)}[case]
    q_idx, q_val = idx[11:12], val[11:12] * np.float32(-1.25)
    qnorm = float(np.sqrt((q_val * q_val).sum()))
    k = K_FOR_KB[kb]
    want = jlsh.fused_sig_query(kind, JKEY, q_idx, q_val, sig, norms,
                                jax.numpy.asarray(mask), H, qnorm, k)
    got = tlsh.fused_sig_query(kind, TKEY, q_idx, q_val, t_sig, t_norms,
                               ROWS, H, qnorm, k, mask=torch.from_numpy(mask))
    assert_top(kind, want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_masked_topk_batch_against_jax(kind):
    idx, val = datums(ROWS, 7)
    sig, norms, (t_sig, t_norms) = table(kind, idx, val)
    mask = holes(4)
    q_idx, q_val = datums(13, 60)
    qnorms = np.sqrt((q_val * q_val).sum(1)).astype(np.float32)
    want = jlsh.fused_sig_query_batch(kind, JKEY, q_idx, q_val, sig, norms,
                                      jax.numpy.asarray(mask), H, qnorms, 30)
    got = tlsh.fused_sig_query_batch(kind, TKEY, q_idx, q_val, t_sig,
                                     t_norms, ROWS, H, qnorms, 30,
                                     mask=torch.from_numpy(mask))
    for i in range(13):
        assert_top(kind, (want[0][i], want[1][i]), (got[0][i], got[1][i]))


def test_a_mask_and_a_count_combine():
    """Rows below the count that the mask keeps are valid: a count and
    a mask give the top of their intersection."""
    idx, val = datums(ROWS, 8)
    _, _, (t_sig, t_norms) = table("lsh", idx, val)
    mask = torch.from_numpy(holes(5))
    qs = t_sig[20:23]
    qn = t_norms[20:23]
    both = tlsh.sig_topk("lsh", t_sig, t_norms, 700, q_sigs=qs, qnorms=qn,
                         hash_num=H, kb=64, mask=mask)
    inter = mask & (torch.arange(ROWS) < 700)
    want = tlsh.sig_topk("lsh", t_sig, t_norms, ROWS, q_sigs=qs, qnorms=qn,
                         hash_num=H, kb=64, mask=inter)
    assert torch.equal(both, want)
    for bad in (mask[:-1], mask.to(torch.int32)):
        with pytest.raises(ValueError, match="mask"):
            tlsh.sig_topk("lsh", t_sig, t_norms, ROWS, q_sigs=qs,
                          qnorms=qn, hash_num=H, kb=8, mask=bad)


def test_keys_to_host_decodes_as_keys_to_rows_scores():
    rng = np.random.default_rng(6)
    s = rng.choice(np.array([-np.inf, -3.5, -0.0, 0.25, 1.0], np.float32),
                   (3, 40))
    keys = tlsh.scores_to_keys(torch.from_numpy(s))
    rows, scores = tlsh.keys_to_host(keys)
    trows, tscores = tlsh.keys_to_rows_scores(keys)
    np.testing.assert_array_equal(rows, trows.numpy())
    np.testing.assert_array_equal(scores.view(np.uint32),
                                  tscores.numpy().view(np.uint32))
    np.testing.assert_array_equal(rows, np.tile(np.arange(40), (3, 1)))


def test_sig_topk_refuses_what_it_cannot_answer():
    table = torch.zeros((10, 2), dtype=torch.int32)
    norms = torch.zeros(10)
    one = torch.zeros(1, dtype=torch.int64)
    for kb in (0, 11):
        with pytest.raises(ValueError, match="kb"):
            tlsh.sig_topk("lsh", table, norms, 10, q_rows=one, hash_num=64,
                          kb=kb)
    with pytest.raises(ValueError, match="valid rows"):
        tlsh.sig_topk("lsh", table, norms, 11, q_rows=one, hash_num=64, kb=8)
    with pytest.raises(ValueError, match="q_sigs"):
        tlsh.sig_topk("lsh", table, norms, 10, hash_num=64, kb=8)
