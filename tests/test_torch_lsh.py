"""The port's LSH operations (jubatus_tpu_torch/ops/lsh.py, plain
versions on the CPU) against the JAX package's (jubatus_tpu/ops/lsh.py)
and against jax.random itself, on seeded numpy inputs.

Tolerances:
- threefry keys (jax.random.key, fold_in), random bits and uniforms:
  bitwise.
- XLA's float32 log1p and log (xla_log1p, xla_log against jnp.log1p,
  jnp.log): bitwise over seeded sweeps, zeros, -1, subnormals, infinities
  and NaN (NaN's bit pattern too).
- normals: bitwise (NORMAL_ULP 0).
- projections (the einsum before the sign) and lsh / euclid_lsh signature
  bits, minhash slots: bitwise at B 1, 31, 64 and 1024, K 16 and 32, H 64
  and 512, and at the other shapes below.  The one band left: at B 1 and
  a width that is no multiple of 16 (B 1, K 20 here), which no converter
  pads to, XLA's vectorized sum has an order of its own; the port sums
  in k order there, and a bit may differ only where the projection lies
  within BAND * sum_k |v_k * n_k| of zero (ROADMAP Queue 3).
- lsh and minhash scores and result lists: bitwise given equal
  signatures, ties in jax.lax.top_k's order (the lower row first).
- euclid_lsh scores: within RTOL relative plus ATOL absolute; the order
  may differ only between rows whose JAX scores lie within that bound.

The port's plain versions run with one torch thread here (the fixture
below), for time, not for their values.  torch's CPU build runs its
elementwise kernels on libgomp threads that spin while they wait; where
other processes hold the cores (pytest-xdist's workers, each with XLA's
CPU client), two such processes stall each other for minutes on what one
alone does in seconds, and with OMP_WAIT_POLICY=PASSIVE they do not.
test_plain_versions_with_all_threads_equal_one_thread holds the values
themselves: the plain signatures and XLA's log1p and log computed with
torch's default threads, in a process without jax, equal one thread's
bit for bit.
"""

import functools

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
NORMAL_ULP = 0
BAND = 1e-6
RTOL = ATOL = 1e-6
KINDS = ("lsh", "minhash", "euclid_lsh")


THREADS_SCRIPT = r"""
import sys
import numpy as np
import torch
from jubatus_tpu_torch.ops import lsh as L
assert "jax" not in sys.modules
torch.set_num_threads(max(4, torch.get_num_threads()))
key = L.prng_key(0x1EAF)
rng = np.random.default_rng(5)
x = torch.from_numpy(rng.uniform(-1, 1, 300_000).astype(np.float32))
idx = torch.from_numpy(rng.integers(0, 1 << 20, (256, 16)).astype(np.int32))
val = torch.from_numpy(rng.standard_normal((256, 16)).astype(np.float32))

def run():
    return [L.xla_log1p(x), L.xla_log(x.abs()),
            L.lsh_signature(key, idx, val, 512),
            L.lsh_signature(key, idx[:1], val[:1], 512),
            L.minhash_signature(key, idx, val, 512)]

many = run()
torch.set_num_threads(1)
for a, b in zip(many, run()):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
print("same")
"""


def test_plain_versions_with_all_threads_equal_one_thread():
    """The plain versions at sizes torch splits across its threads
    (elementwise ops of 131,072 to 300,000 elements), with the default
    thread count (at least 4), in a process that never imports jax:
    bitwise one thread's.  Passive waiting keeps the process from stalling beside
    other busy workers (the module docstring)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE")
    env.pop("OMP_NUM_THREADS", None)
    proc = subprocess.run([sys.executable, "-c", THREADS_SCRIPT], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "same", \
        proc.stderr[-2000:]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _log_sweep(seed):
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, -1.0, -2.0, 1.0, np.inf, -np.inf, np.nan,
                        1e-40, -1e-40, 1e-45, 1.1754942e-38, 1.1754944e-38,
                        0.41421354, -0.41421354, 0.41421357, -0.41421357,
                        3.4028235e38], np.float32)
    return rng, special


def test_xla_log1p_is_bitwise_jnp_log1p():
    rng, special = _log_sweep(11)
    x = np.concatenate([
        rng.uniform(-1.0, 1.0, 400_000), rng.uniform(-1e-3, 1e-3, 20_000),
        -np.logspace(-45, 0, 20_000), np.logspace(-45, 10, 20_000),
        special]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = tlsh.xla_log1p(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_xla_log_is_bitwise_jnp_log():
    rng, special = _log_sweep(12)
    x = np.concatenate([
        rng.uniform(1e-12, 1.0, 400_000), np.logspace(-12, 0, 20_000),
        np.logspace(-45, 38, 20_000), -np.logspace(-3, 3, 100),
        special]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = tlsh.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


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
    np.testing.assert_array_equal(want, got.view(np.uint32))
    # the empty datum projects to +0: every hash bit 1, the tail 0
    np.testing.assert_array_equal(_unpack(got.view(np.uint32)[:1], h), True)


@pytest.mark.parametrize("h", [1, 64, 77, 512])
def test_minhash_signature_against_jax(h):
    idx, val = batch(1000 + h)
    want = np.asarray(jlsh.minhash_signature(JKEY, idx, val, h))
    got = tlsh.minhash_signature(TKEY, torch.from_numpy(idx),
                                 torch.from_numpy(val), h).numpy()
    assert got.shape == (idx.shape[0], h)
    np.testing.assert_array_equal(want, got.view(np.uint32))
    # a datum whose values are all zero keeps slot index 0
    np.testing.assert_array_equal(got[0], idx[0, 0])


SIG_SHAPES = [(b, k, h) for b in (1, 31, 64, 1024) for k in (16, 32)
              for h in (64, 512)]


def datums(seed, b, k, d=1 << 20):
    """b random datums of k features; from four datums on, the edge rows
    of batch()."""
    if b >= 4:
        return batch(seed, b=b, k=k, d=d)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d, (b, k)).astype(np.int32),
            rng.standard_normal((b, k)).astype(np.float32))


@pytest.mark.parametrize("kind", ["lsh", "minhash"])
@pytest.mark.parametrize("b, k, h", SIG_SHAPES)
def test_signatures_are_bitwise_jax(kind, b, k, h):
    """Every kind's signature at the shapes the port signs (a set_row or
    datum read at B 1, a lane sweep at B 31 and 64, a table build at B
    1024) equals the JAX package's bit for bit.  euclid_lsh signs with
    the lsh function in both packages, so the lsh case holds JAX's
    euclid_lsh signature too (test_euclid_signs_as_lsh holds the port's
    dispatch)."""
    idx, val = datums(100 * b + k + h, b, k)
    got = tlsh.signature(TKEY, torch.from_numpy(idx), torch.from_numpy(val),
                         h, kind).numpy().view(np.uint32)
    kinds = ("lsh", "euclid_lsh") if kind == "lsh" else (kind,)
    for kd in kinds:
        want = np.asarray(jlsh.signature(JKEY, idx, val, h, kd))
        np.testing.assert_array_equal(want, got, err_msg=kd)


def test_euclid_signs_as_lsh():
    idx, val = datums(4, 5, 16)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    assert torch.equal(tlsh.signature(TKEY, ti, tv, 64, "euclid_lsh"),
                       tlsh.signature(TKEY, ti, tv, 64, "lsh"))


@functools.partial(jax.jit, static_argnames=("hash_num",))
def _jax_projection(key, indices, values, hash_num):
    """jubatus_tpu.ops.lsh.lsh_signature up to its einsum (the same code,
    ending before the sign)."""
    def feature_row(i):
        return jax.random.normal(jax.random.fold_in(key, i), (hash_num,))
    rows = jax.vmap(jax.vmap(feature_row))(indices)
    return jnp.einsum("bkh,bk->bh", rows, values)


def _projections(b, k, h, seed):
    idx, val = datums(seed, b, k)
    want = np.asarray(_jax_projection(JKEY, idx, val, h))
    got = tlsh.project(tlsh.feature_normals(TKEY, torch.from_numpy(idx), h),
                       torch.from_numpy(val),
                       tlsh.projection_order(b, k)).numpy()
    return idx, val, want, got


@pytest.mark.parametrize("b, k, h", [(1, 16, 64), (1, 32, 512), (1, 48, 64),
                                     (1, 64, 64), (1, 128, 64), (2, 16, 64),
                                     (31, 32, 512), (64, 48, 64),
                                     (5, 13, 64), (3, 100, 64),
                                     (1024, 16, 64)])
def test_projections_are_bitwise_xla(b, k, h):
    """The projection itself, before its sign, equals XLA's bit for bit:
    eight lanes at one datum whose K is a multiple of 16 (16, 32, 48, 64,
    128), k order at every B > 1 (any K)."""
    _, _, want, got = _projections(b, k, h, 7 * b + k)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_projection_band_at_one_datum_of_another_width():
    """B 1, K 20 (no converter width): XLA's vectorized sum has an order
    of its own there and the port sums in k order; signature bits differ
    only inside the band."""
    idx, val, want, got = _projections(1, 20, 512, 20)
    assert tlsh.projection_order(1, 20) == tlsh.ORDER_K
    wsig = np.asarray(jlsh.lsh_signature(JKEY, idx, val, 512))
    gsig = tlsh.lsh_signature(TKEY, torch.from_numpy(idx),
                              torch.from_numpy(val), 512).numpy()
    inside, outside = lsh_band_flips(idx, val, 512, wsig, gsig.view(np.uint32))
    assert outside == 0, (inside, outside)
    np.testing.assert_allclose(got, want, rtol=0, atol=BAND * np.abs(
        val[..., None].astype(np.float64)
        * _jax_normals(idx, 512)).sum(1).max())


def test_signatures_read_subnormal_values_as_zero():
    """XLA's CPU code reads float32 subnormals as zero (DAZ): such a
    feature adds nothing to a projection and never wins a minhash slot."""
    idx, val = batch(9, b=8, k=16)
    val[:, ::3] = np.float32(1e-40)
    for kind in ("lsh", "minhash"):
        want = np.asarray(jlsh.signature(JKEY, idx, val, 64, kind))
        got = tlsh.signature(TKEY, torch.from_numpy(idx),
                             torch.from_numpy(val), 64, kind).numpy()
        np.testing.assert_array_equal(want, got.view(np.uint32))


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
    """n_valid is a row count; a validity mask (a table with holes) goes
    in the mask argument, never in the count's place."""
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


# ---------------------------------------------------------------------------
# the exact sweeps (K4's plain versions) and the all-rows counts (K5's)
# against the JAX functions, at Kr 32, 64 and 128, with mask holes
# ---------------------------------------------------------------------------

def sparse_table(rows, kr, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (rows, kr)).astype(np.int32)
    val = rng.standard_normal((rows, kr)).astype(np.float32)
    nz = rng.integers(1, kr + 1, rows)
    for r in range(rows):
        idx[r, nz[r]:] = 0
        val[r, nz[r]:] = 0.0
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return idx, val, norms


@pytest.mark.parametrize("kr", [32, 64, 128])
@pytest.mark.parametrize("metric", ["cosine", "euclid"])
def test_fused_dense_query_is_bitwise_jax(kr, metric):
    d, rows = 1024, 512
    idx, val, norms = sparse_table(rows, kr, d, kr)
    rng = np.random.default_rng(kr + 1)
    mask = rng.random(rows) < 0.7
    for q_seed, k in ((1, 5), (2, 60), (3, 400)):
        q = np.random.default_rng(q_seed).standard_normal(d).astype(
            np.float32)
        q[np.random.default_rng(q_seed + 9).random(d) < 0.4] = 0.0
        qn = float(np.sqrt((q * q).sum()))
        for valid, tmask in ((jnp.asarray(mask), torch.from_numpy(mask)),
                             (np.int32(rows - 30), None)):
            want = jlsh.fused_dense_query(metric, idx, val, norms, valid, q,
                                          qn, k)
            got = tlsh.fused_dense_query(
                metric, torch.from_numpy(idx), torch.from_numpy(val),
                torch.from_numpy(norms), rows if tmask is not None
                else rows - 30, tmask, q, qn, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1].view(np.uint32),
                                          want[1].view(np.uint32))


@pytest.mark.parametrize("kr", [32, 64, 128, 1024])
def test_dense_dots_are_bitwise_chunk_dots(kr):
    from jubatus_tpu.models.anomaly import _chunk_dots
    d = 1024
    idx, val, _ = sparse_table(256, kr, d, 100 + kr)
    q = np.random.default_rng(kr).standard_normal((8, d)).astype(np.float32)
    want = np.asarray(_chunk_dots(jnp.asarray(idx), jnp.asarray(val),
                                  jnp.asarray(q)))
    got = tlsh.dense_dots(torch.from_numpy(idx), torch.from_numpy(val),
                          torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# K5's widths (lsh and euclid_lsh up to H 512, minhash H 256) at 6
# queries (the first cases, ids unchanged) and 1, 7 and 64
_SIM_CASES = [(k, h, nq) for nq in (6, 1, 7, 64)
              for h in (64, 128, 256, 512)
              for k in ("lsh", "minhash", "euclid_lsh")
              if (h == 256) == (k == "minhash") or h < 256]


@pytest.mark.parametrize(
    "kind,hash_num,nq", _SIM_CASES,
    ids=[f"{h}-{k}" if nq == 6 else f"{h}-{k}-nq{nq}"
         for k, h, nq in _SIM_CASES])
def test_table_similarities_batch_is_bitwise_jax(kind, hash_num, nq):
    """Over a table of 512 rows (XLA's scalar tail of a row count no
    multiple of 16 fuses euclid_lsh's estimate in another order: the
    stores' capacities are multiples of 128), at K5's widths (2 to 256
    words a row) and query counts (one add's sweep, a refresh's batch, a
    read lane's)."""
    rng = np.random.default_rng(hash_num)
    w, rows = tlsh.sig_width(kind, hash_num), 512
    tab = rng.integers(0, 2 ** 32, (rows, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "minhash":
        tab %= 5
    qs = tab[rng.integers(0, rows, nq)].copy()
    qs[:, 0] ^= 9
    norms = (rng.random(rows) * 4).astype(np.float32)
    qn = (rng.random(nq) * 4).astype(np.float32)
    want = jlsh.table_similarities_batch(kind, jnp.asarray(tab), qs,
                                         hash_num, jnp.asarray(norms), qn)
    got = tlsh.table_similarities_batch(
        kind, torch.from_numpy(tab.view(np.int32)), qs, hash_num,
        torch.from_numpy(norms), qn)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_euclid_cos_tables_are_xla_s():
    """The euclid cosines of K3's sweep and of _euclid_b, as XLA computes
    them (the C library's cosf), at H 128 and 512 where the correctly
    rounded cosine differs."""
    for h in (128, 512):
        c = jnp.arange(32 * tlsh.words_for(h) + 1, dtype=jnp.int32)
        want = np.asarray(jax.jit(
            lambda d, hh: jnp.cos(jnp.pi * d.astype(jnp.float32) / hh))(
                c, np.float32(h)))
        np.testing.assert_array_equal(tlsh.euclid_cos_table(h).view(
            np.uint32), want.view(np.uint32))
        want = np.asarray(jax.jit(
            lambda d: jnp.cos(jnp.pi * d.astype(jnp.float32) / h))(c))
        np.testing.assert_array_equal(
            tlsh.count_table("euclid_lsh", h).view(np.uint32),
            want.view(np.uint32))
