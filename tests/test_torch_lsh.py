"""The port's LSH operations (jubatus_tpu_torch/ops/lsh.py, plain
versions on the CPU) against the JAX package's (jubatus_tpu/ops/lsh.py)
and against jax.random itself, on seeded numpy inputs.

Tolerances:
- threefry keys (jax.random.key, fold_in), random bits and uniforms:
  bitwise.
- normals: within NORMAL_ULP ulp (XLA's log1p differs from torch's in the
  last bits; measured at most 3 over 64,000 draws).
- lsh / euclid_lsh signature bits: bitwise except where the projection
  lies within BAND * sum_k |v_k * n_k| of zero (a rounding of the sum may
  flip its sign there); each such position is counted, and any flip
  outside the band fails.
- minhash slots: equal except where the two smallest exponentials lie
  within BAND relative of each other.
- lsh and minhash scores and result lists: bitwise given equal
  signatures, ties in jax.lax.top_k's order (the lower row first).
- euclid_lsh scores: within RTOL relative plus ATOL absolute; the order
  may differ only between rows whose JAX scores lie within that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.ops import lsh as jlsh
from jubatus_tpu_torch.ops import lsh as tlsh

SEED = 0x1EAF
JKEY = jax.random.key(SEED)
TKEY = tlsh.prng_key(SEED)
NORMAL_ULP = 4
BAND = 1e-6
RTOL = ATOL = 1e-6
KINDS = ("lsh", "minhash", "euclid_lsh")


def _jfold(ids):
    return jax.vmap(lambda i: jax.random.fold_in(JKEY, i))(
        jnp.asarray(ids, jnp.int32))


def _tfold(ids):
    return tlsh.fold_in(TKEY, torch.from_numpy(np.asarray(ids, np.int32)))


IDS = np.array([0, 1, 2, 5, 1000, 4095, 7919, 65535, 2**31 - 1], np.int32)


# ---------------------------------------------------------------------------
# the PRNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, SEED, 123456789, 2**31 - 1, -1,
                                  -2**31])
def test_prng_key_is_jax_key(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert tuple(int(x) for x in want) == tlsh.prng_key(seed)


def test_fold_in_is_bitwise_jax():
    want = np.asarray(jax.random.key_data(_jfold(IDS)))
    f1, f2 = _tfold(IDS)
    np.testing.assert_array_equal(want[:, 0], f1.numpy())
    np.testing.assert_array_equal(want[:, 1], f2.numpy())


def test_threefry_matches_jax_primitive():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 257), dtype=np.uint64).astype(np.uint32)
    from jax._src import prng as jprng
    want = jprng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
        jnp.asarray(x[1]))
    got = tlsh.threefry2x32(int(k[0]), int(k[1]),
                            torch.from_numpy(x[0].astype(np.int64)),
                            torch.from_numpy(x[1].astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("n", [1, 31, 64, 77, 512])
def test_bits_are_bitwise_jax(n):
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(
        _jfold(IDS)))
    got = tlsh.random_bits(*_tfold(IDS), n).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n", [64, 512])
def test_minhash_uniforms_are_bitwise_jax(n):
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=1e-12, maxval=1.0))(_jfold(IDS)))
    got = tlsh.uniform_from_bits(tlsh.random_bits(*_tfold(IDS), n),
                                 tlsh._MINHASH_LO, 1.0).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_normal_uniforms_are_bitwise_jax():
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (64,), minval=lo, maxval=1.0))(_jfold(IDS)))
    got = tlsh.uniform_from_bits(tlsh.random_bits(*_tfold(IDS), 64),
                                 tlsh._NORMAL_LO, 1.0).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_normals_within_the_ulp_bound():
    ids = np.random.default_rng(1).integers(0, 2**31 - 1, 1000)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (64,)))(
        _jfold(ids)))
    got = tlsh.normal_from_bits(tlsh.random_bits(*_tfold(ids), 64)).numpy()
    ulp = np.abs(want.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert ulp.max() <= NORMAL_ULP, ulp.max()
    # most draws are bitwise: the polynomial's fused steps are XLA's
    assert (ulp == 0).mean() > 0.95


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def batch(seed, b=48, k=16, d=4096):
    """Random datums plus the edge rows: an empty datum (all padding),
    a half-padded one, one with a repeated feature and one with a
    negative zero value."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (b, k)).astype(np.int32)
    val = rng.standard_normal((b, k)).astype(np.float32)
    idx[0], val[0] = 0, 0.0
    idx[1, k // 2:], val[1, k // 2:] = 0, 0.0
    idx[2, 1] = idx[2, 0]
    val[3, 0] = -0.0
    return idx, val


def _jax_normals(idx, h):
    return np.asarray(jax.vmap(jax.vmap(
        lambda i: jax.random.normal(jax.random.fold_in(JKEY, i), (h,))))(
            jnp.asarray(idx))).astype(np.float64)


def _unpack(words, h):
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :h].astype(bool)


def lsh_band_flips(idx, val, h, want, got):
    """(flips inside the band, flips outside it) of two signatures."""
    n = _jax_normals(idx, h)
    terms = val.astype(np.float64)[..., None] * n
    proj, scale = terms.sum(1), np.abs(terms).sum(1)
    diff = _unpack(want, h) != _unpack(got, h)
    band = np.abs(proj) <= BAND * scale
    return int((diff & band).sum()), int((diff & ~band).sum())


@pytest.mark.parametrize("h", [1, 32, 64, 77, 512])
def test_lsh_signature_against_jax(h):
    idx, val = batch(h)
    want = np.asarray(jlsh.lsh_signature(JKEY, idx, val, h))
    got = tlsh.lsh_signature(TKEY, torch.from_numpy(idx),
                             torch.from_numpy(val), h).numpy()
    assert got.shape == (idx.shape[0], tlsh.words_for(h))
    inside, outside = lsh_band_flips(idx, val, h, want, got.view(np.uint32))
    assert outside == 0, (inside, outside)
    # the empty datum projects to +0: every hash bit 1, the tail 0
    np.testing.assert_array_equal(_unpack(got.view(np.uint32)[:1], h), True)
    np.testing.assert_array_equal(want[0], got.view(np.uint32)[0])


@pytest.mark.parametrize("h", [1, 64, 77, 512])
def test_minhash_signature_against_jax(h):
    idx, val = batch(1000 + h)
    want = np.asarray(jlsh.minhash_signature(JKEY, idx, val, h))
    got = tlsh.minhash_signature(TKEY, torch.from_numpy(idx),
                                 torch.from_numpy(val), h).numpy()
    assert got.shape == (idx.shape[0], h)
    got = got.view(np.uint32)
    u = np.asarray(jax.vmap(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(JKEY, i), (h,), minval=1e-12, maxval=1.0)))(
            jnp.asarray(idx))).astype(np.float64)
    w = np.abs(val.astype(np.float64))[..., None]
    e = np.where(w > 0, -np.log(u) / np.maximum(w, 1e-12), np.inf)
    e.sort(axis=1)
    with np.errstate(invalid="ignore"):    # inf - inf: no second value
        near = (e[:, 1] - e[:, 0]) <= BAND * np.abs(e[:, 0])
    diff = want != got
    assert not (diff & ~near).any(), int((diff & ~near).sum())
    # a datum whose values are all zero keeps slot index 0
    np.testing.assert_array_equal(got[0], idx[0, 0])


def test_padding_does_not_change_a_signature():
    """Zero-valued padding (index 0) appended to a datum leaves both
    signatures as they are, as in the JAX package."""
    idx, val = batch(7, b=8, k=16)
    pidx = np.concatenate([idx, np.zeros_like(idx)], 1)
    pval = np.concatenate([val, np.zeros_like(val)], 1)
    for kind in ("lsh", "minhash"):
        a = tlsh.signature(TKEY, torch.from_numpy(idx),
                           torch.from_numpy(val), 64, kind)
        b = tlsh.signature(TKEY, torch.from_numpy(pidx),
                           torch.from_numpy(pval), 64, kind)
        assert torch.equal(a, b), kind


def test_host_signature_is_uint32():
    idx, val = batch(3, b=4)
    sig = tlsh.host_signature(TKEY, idx, val, 64, "lsh", "cpu")
    assert sig.dtype == np.uint32 and sig.shape == (4, 2)


# ---------------------------------------------------------------------------
# keys and the sweep
# ---------------------------------------------------------------------------

def test_keys_order_as_top_k():
    rng = np.random.default_rng(5)
    s = rng.choice(np.array([-np.inf, -3.5, -1.0, -0.0, 0.0, 1e-38, 0.25,
                             1.0, 7.0], np.float32), 257)
    keys = tlsh.scores_to_keys(torch.from_numpy(s))
    order = torch.argsort(keys, descending=True).numpy()
    rows, back = tlsh.keys_to_rows_scores(keys)
    np.testing.assert_array_equal(rows.numpy(), np.arange(257))
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  s.view(np.uint32))
    top_s, top_r = jax.lax.top_k(jnp.asarray(s), 257)
    # -0.0 and 0.0 tie in top_k and not in the keys; no score of the
    # three kinds is ever +0.0 beside a -0.0, so compare without them
    keep = s != 0.0
    np.testing.assert_array_equal(
        order[keep[order]], np.asarray(top_r)[keep[np.asarray(top_r)]])


def sig_table(kind, h, rows, seed):
    """A table with many tied scores: signatures of datums built from few
    features, so rows repeat."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 24, (rows, 2)).astype(np.int32)
    val = rng.choice(np.array([-1.0, 0.5, 2.0], np.float32), (rows, 2))
    sig = np.asarray(jlsh.signature(JKEY, idx, val, h, kind))
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return sig, norms, idx, val


def _tt(sig, norms):
    return (torch.from_numpy(sig.view(np.int32).copy()),
            torch.from_numpy(norms.copy()))


def assert_same_top(kind, want, got):
    (wr, ws), (gr, gs) = want, got
    wr, ws, gr, gs = map(np.asarray, (wr, ws, gr, gs))
    assert wr.shape == gr.shape
    if kind != "euclid_lsh":
        np.testing.assert_array_equal(wr, gr)
        np.testing.assert_array_equal(ws.view(np.uint32), gs.view(np.uint32))
        return
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(fin, np.isfinite(gs))
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    for i in np.nonzero(wr != gr)[0]:
        # a reordering only between rows whose JAX scores are that close
        other = np.nonzero(wr == gr[i])[0]
        assert other.size and abs(ws[other[0]] - ws[i]) <= \
            ATOL + RTOL * abs(ws[i]), (i, wr, gr)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows, k", [(300, 10), (300, 40), (5, 10)])
def test_sweep_by_datum_against_jax(kind, rows, k):
    h = 64
    sig, norms, idx, val = sig_table(kind, h, rows, 11)
    table, tnorms = _tt(sig, norms)
    q = min(7, rows - 1)
    q_idx, q_val = idx[q:q + 1], val[q:q + 1] * np.float32(1.5)
    qnorm = float(np.sqrt((q_val * q_val).sum()))
    valid = rows - 2
    want = jlsh.fused_sig_query(kind, JKEY, q_idx, q_val, sig, norms, valid,
                                h, qnorm, k)
    got = tlsh.fused_sig_query(kind, TKEY, q_idx, q_val, table, tnorms,
                               valid, h, qnorm, k)
    assert_same_top(kind, want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_by_row_against_jax(kind):
    h = 64
    sig, norms, _, _ = sig_table(kind, h, 200, 12)
    table, tnorms = _tt(sig, norms)
    for row in (0, 17, 199):
        want = jlsh.fused_sig_query_row(kind, sig, row, norms, 200, h, 10)
        got = tlsh.fused_sig_query_row(kind, table, row, tnorms, 200, h, 10)
        assert_same_top(kind, want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_batch_against_jax(kind):
    h = 77
    sig, norms, idx, val = sig_table(kind, h, 260, 14)
    table, tnorms = _tt(sig, norms)
    q_idx, q_val = idx[:5], val[:5] * np.float32(-0.75)
    qnorms = np.sqrt((q_val * q_val).sum(1)).astype(np.float32)
    want = jlsh.fused_sig_query_batch(kind, JKEY, q_idx, q_val, sig, norms,
                                      260, h, qnorms, 12)
    got = tlsh.fused_sig_query_batch(kind, TKEY, q_idx, q_val, table, tnorms,
                                     260, h, qnorms, 12)
    for i in range(5):
        assert_same_top(kind, (want[0][i], want[1][i]),
                        (got[0][i], got[1][i]))


@pytest.mark.parametrize("kind", KINDS)
def test_similarities_against_jax(kind):
    h = 64
    sig, norms, _, _ = sig_table(kind, h, 90, 16)
    table, tnorms = _tt(sig, norms)
    want = np.asarray(jlsh._sig_similarities(
        kind, jnp.asarray(sig), jnp.asarray(sig[4]), jnp.asarray(norms),
        jnp.float32(norms[4]), h))
    got = tlsh.similarities_ref(kind, table, table[4], tnorms, tnorms[4],
                                h).numpy()
    if kind == "euclid_lsh":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_round_k_buckets():
    for k in (0, 1, 8, 9, 16, 17, 100, 1000):
        assert tlsh._round_k(k) == jlsh._round_k(k)


def test_sweep_refuses_an_unknown_kind():
    table = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown signature kind"):
        tlsh.sig_topk("cosine", table, torch.zeros(4), 4,
                      q_rows=torch.zeros(1, dtype=torch.int64), hash_num=64)


def test_sweep_takes_a_row_count_only():
    """The store's rows are a prefix, so validity is a count; a mask (a
    table with holes) is refused until an engine frees rows."""
    table = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="row count"):
        tlsh.sig_topk("lsh", table, torch.zeros(4),
                      torch.ones(4, dtype=torch.bool),
                      q_rows=torch.zeros(1, dtype=torch.int64), hash_num=64)


def test_fused_query_without_norms():
    sig, norms, idx, val = sig_table("lsh", 64, 40, 20)
    table, _ = _tt(sig, norms)
    want = jlsh.fused_sig_query("lsh", JKEY, idx[:1], val[:1], sig, None, 40,
                                64, 0.0, 8)
    got = tlsh.fused_sig_query("lsh", TKEY, idx[:1], val[:1], table, None,
                               40, 64, 0.0, 8)
    assert_same_top("lsh", want, got)
