"""The port's classifier (jubatus_tpu_torch/models/classifier.py and the
modules under it) against the JAX package, on the CPU at a small size.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port.  Tolerances: labels, counts and active
are integers and must match bitwise; w, cov and scores are float32 sums
taken in another order by the two packages, so they agree within
rtol 1e-5 / atol 1e-6.  The seeded streams keep margins away from the
0 and 1 branch edges, where a last-bit difference could flip an update.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.batching import bucketing as jbucket
from jubatus_tpu.fv import ConverterConfig as JConverterConfig
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.fv import DatumToFVConverter as JConverter
from jubatus_tpu.models import classifier as jc
from jubatus_tpu.ops import sparse as jsparse
from jubatus_tpu_torch.batching import bucketing as tbucket
from jubatus_tpu_torch.fv import ConverterConfig as TConverterConfig
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.fv import DatumToFVConverter as TConverter
from jubatus_tpu_torch.models import classifier as tc
from jubatus_tpu_torch.ops import sparse as tsparse

# the suite's files run side by side in worker processes: one intra-op
# thread keeps these small tensors from contending for the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MARGIN = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")
CENTROID = ("cosine", "euclidean")
COV = ("CW", "AROW", "NHERD")


def config(method="AROW", dim=1 << 12, c=1.0, **param):
    return {
        "method": method,
        "parameter": {"regularization_weight": c, **param},
        "converter": {
            "string_rules": [{"key": "*", "type": "str",
                              "sample_weight": "bin", "global_weight": "bin"}],
            "num_rules": [{"key": "*", "type": "num"}],
            "hash_max_size": dim,
        },
    }


def stream(rng, n, n_labels=5, vocab=200):
    """n (label, string pairs, number pairs) records, bench-shaped."""
    out = []
    for i in range(n):
        s = [(f"w{t % 4}", f"tok{t}") for t in rng.integers(0, vocab, 5)]
        out.append((f"c{i % n_labels}", s, [("x", float(rng.random()))]))
    return out


def jdata(records):
    return [(lbl, JDatum(list(s), list(n))) for lbl, s, n in records]


def tdata(records):
    return [(lbl, TDatum(list(s), list(n))) for lbl, s, n in records]


def scores(res):
    return np.array([[sc for _, sc in row] for row in res], np.float64)


def assert_same_state(jd, td):
    """Integer state bitwise, float tables within tolerance."""
    assert td.labels == jd.labels
    assert td.capacity == jd.capacity
    np.testing.assert_array_equal(td.counts.numpy(), np.asarray(jd.counts))
    np.testing.assert_array_equal(td.active.numpy(), np.asarray(jd.active))
    np.testing.assert_allclose(td.w.numpy(), np.asarray(jd.w),
                               rtol=RTOL, atol=ATOL)
    if jd.method in COV:
        np.testing.assert_allclose(td.cov.numpy(), np.asarray(jd.cov),
                                   rtol=RTOL, atol=ATOL)


def assert_same_classify(jres, tres):
    assert [[lbl for lbl, _ in r] for r in tres] == \
        [[lbl for lbl, _ in r] for r in jres]
    np.testing.assert_allclose(scores(tres), scores(jres), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# module level: the train step
# ---------------------------------------------------------------------------

def scan_inputs(seed, L=8, D=256, B=64, K=16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    cov = (1 + rng.random((L, D))).astype(np.float32)
    counts = rng.integers(0, 3, L).astype(np.int32)
    active = counts > 0
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    val[:, 12:] = 0.0
    idx[:, 12:] = 0                     # padding, as the converter pads
    lab = rng.integers(0, L, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[-5:] = 0.0                     # padding datums
    return (w, cov, counts, active), (idx, val, lab, mask)


def run_both(jfn, tfn, state, batch, method, c=0.5):
    out_j = jfn(*(jnp.asarray(a) for a in state + batch), method, c)
    t_state = [torch.from_numpy(a.copy()) for a in state]
    tfn(*t_state, *(torch.from_numpy(a) for a in batch), method, c)
    return [np.asarray(a) for a in out_j], [t.numpy() for t in t_state]


def assert_step_matches(out_j, out_t):
    np.testing.assert_array_equal(out_t[2], out_j[2])        # counts
    np.testing.assert_array_equal(out_t[3], out_j[3])        # active
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_t[1], out_j[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", MARGIN)
def test_train_scan_ref_matches_train_scan_impl(method):
    state, batch = scan_inputs(1)
    out_j, out_t = run_both(jc.train_scan_impl, tc.train_scan_ref, state,
                            batch, method)
    assert_step_matches(out_j, out_t)
    assert not np.array_equal(out_t[0], state[0])           # it trained


@pytest.mark.parametrize("method", MARGIN)
def test_train_scan_wrapper_on_cpu_is_the_plain_version(method):
    state, batch = scan_inputs(2)
    out_j, out_t = run_both(jc.train_scan_impl, tc.train_scan, state,
                            batch, method)
    assert_step_matches(out_j, out_t)


@pytest.mark.parametrize("method", MARGIN)
def test_train_parallel_matches_train_parallel_impl(method):
    """Duplicate (row, column) factors compound in another order than
    XLA's, so cov agrees within tolerance, not bitwise."""
    state, batch = scan_inputs(3)
    out_j, out_t = run_both(jc.train_parallel_impl, tc.train_parallel,
                            state, batch, method)
    assert_step_matches(out_j, out_t)


@pytest.mark.parametrize("method", COV)
def test_column0_duplicate_keeps_the_padding_write(method):
    """A real feature at column 0 shares its index with the padding
    entries.  The reference's scatter-set applies in order on the CPU, so
    the last padding entry's stale covariance wins: cov[y, 0] and
    cov[r, 0] keep their old values while w[y, 0] still moves."""
    L, D, K = 4, 64, 16
    w = np.zeros((L, D), np.float32)
    w[1, 5] = 0.3                       # label 1 is the rival
    cov = np.ones((L, D), np.float32)
    counts = np.array([0, 1, 0, 0], np.int32)
    active = counts > 0
    idx = np.zeros((1, K), np.int32)
    val = np.zeros((1, K), np.float32)
    idx[0, :3] = [0, 5, 9]
    val[0, :3] = [1.5, 1.0, -0.5]       # a real feature at column 0
    lab = np.array([2], np.int32)
    mask = np.ones(1, np.float32)
    out_j, out_t = run_both(jc.train_scan_impl, tc.train_scan_ref,
                            (w, cov, counts, active),
                            (idx, val, lab, mask), method, 1.0)
    assert_step_matches(out_j, out_t)
    for out in (out_j, out_t):
        assert out[1][2, 0] == 1.0 and out[1][1, 0] == 1.0
        assert out[1][2, 5] != 1.0 and out[1][1, 9] != 1.0
        assert out[0][2, 0] != 0.0


def test_argmax_ties_take_the_lowest_row():
    """With every score 0 the rival is the first active row other than y
    (jnp.argmax's first maximum)."""
    L, D, K = 6, 32, 16
    state = (np.zeros((L, D), np.float32), np.ones((L, D), np.float32),
             np.array([0, 0, 1, 1, 1, 1], np.int32),
             np.array([0, 0, 1, 1, 1, 1], bool))
    idx = np.zeros((1, K), np.int32)
    val = np.zeros((1, K), np.float32)
    idx[0, :2] = [3, 7]
    val[0, :2] = [1.0, 2.0]
    batch = (idx, val, np.array([4], np.int32), np.ones(1, np.float32))
    out_j, out_t = run_both(jc.train_scan_impl, tc.train_scan_ref, state,
                            batch, "PA")
    assert_step_matches(out_j, out_t)
    moved = np.flatnonzero(np.abs(out_t[0]).sum(axis=1))
    assert moved.tolist() == [2, 4]


def test_no_active_rival_is_a_counted_noop():
    state, _ = scan_inputs(4, L=4)
    state = (state[0], state[1], np.zeros(4, np.int32), np.zeros(4, bool))
    idx = np.zeros((2, 16), np.int32)
    idx[:, 0] = 3
    val = np.zeros((2, 16), np.float32)
    val[:, 0] = 1.0
    batch = (idx, val, np.array([1, 1], np.int32), np.ones(2, np.float32))
    out_j, out_t = run_both(jc.train_scan_impl, tc.train_scan_ref, state,
                            batch, "AROW")
    assert_step_matches(out_j, out_t)
    np.testing.assert_array_equal(out_t[0], state[0])
    assert out_t[2].tolist() == [0, 2, 0, 0]


def hazard_inputs(seed, L=8, D=128, B=96, K=16):
    """The read-after-write hazard of the scan kernel's prefetch ring:
    every datum carries one shared column (as the numeric feature `x@num`
    hashes to one column) and the padding column 0; the first half uses
    two labels only, so consecutive datums repeat a label or take the
    previous datum's rival as their own label; some datums repeat a column
    or carry a real column-0 feature; runs of padding datums and of
    not-ok datums (all values 0) sit inside any lookahead window."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    cov = (1 + rng.random((L, D))).astype(np.float32)
    counts = np.zeros(L, np.int32)
    counts[:2] = 1
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    idx[:, 9:] = 0
    val[:, 9:] = 0.0
    idx[:, 8] = 5                       # the shared column
    idx[::7, 0] = 0                     # real column-0 features
    idx[::5, 3] = idx[::5, 1]           # duplicate columns in a datum
    lab = np.where(np.arange(B) < B // 2, rng.integers(0, 2, B),
                   rng.integers(0, L, B)).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[10:13] = 0.0                   # padding datums
    val[20:23] = 0.0                    # not ok: |x|^2 = 0
    return (w, cov, counts, counts > 0), (idx, val, lab, mask)


@pytest.mark.parametrize("fn", ("train_scan_ref", "train_scan"))
@pytest.mark.parametrize("method", MARGIN)
def test_shared_column_stream_matches_train_scan_impl(method, fn):
    state, batch = hazard_inputs(11)
    out_j, out_t = run_both(jc.train_scan_impl, getattr(tc, fn), state,
                            batch, method)
    assert_step_matches(out_j, out_t)
    assert out_t[0][:, 5].any()         # the shared column was trained


@pytest.mark.parametrize("n_labels,k,has_cov,plan", [
    (32, 16, True, (tc.SCAN_RING_ALL, tc.SCAN_RING)),   # the main path
    (8, 16, False, (tc.SCAN_RING_ALL, tc.SCAN_RING)),
    (256, 64, True, (tc.SCAN_RING_ALL, 1)),
    (512, 64, True, (tc.SCAN_RING_W, 1)),               # cov on demand
    (512, 64, False, (tc.SCAN_RING_ALL, 1)),
    (1024, 64, True, (tc.SCAN_DIRECT, tc.SCAN_RING)),
    (32, 4096, True, (tc.SCAN_DIRECT, 2)),
])
def test_scan_plan_takes_the_deepest_ring_that_fits(n_labels, k, has_cov,
                                                    plan):
    mode, depth = tc.scan_plan(n_labels, k, has_cov)
    assert (mode, depth) == plan
    assert tc.scan_smem_bytes(mode, has_cov, depth, n_labels, k) <= \
        tc.SCAN_SMEM_LIMIT
    if depth < tc.SCAN_RING:
        assert tc.scan_smem_bytes(mode, has_cov, depth + 1, n_labels, k) > \
            tc.SCAN_SMEM_LIMIT


def test_scan_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        tc.scan_plan(32, 8192, True)
    assert tc.scan_plan(32, 16, True, ring=1) == (tc.SCAN_RING_ALL, 1)


def test_train_scan_wrapper_refuses_other_devices():
    state, batch = scan_inputs(5)
    meta = [torch.from_numpy(a).to("meta") for a in state + batch]
    before = tc.train_scan.launches
    with pytest.raises(ValueError):
        tc.train_scan(*meta, "AROW", 1.0)
    assert tc.train_scan.launches == before


def test_packed_batch_views_roundtrip():
    _, (idx, val, lab, mask) = scan_inputs(6)
    buf = torch.from_numpy(tc._pack_batch(idx, val, lab, mask))
    np.testing.assert_array_equal(jc._pack_batch(idx, val, lab, mask),
                                  buf.numpy())
    for a, t in zip((idx, val, lab, mask),
                    tc._unpack_batch(buf, *idx.shape)):
        np.testing.assert_array_equal(t.numpy(), a)


SUBNORMAL = {"tiny_norm": [3e-20, 3e-20], "subnormal_value": [1e-39, 1.0]}


@pytest.mark.parametrize("fn", ("train_scan_ref", "train_scan"))
@pytest.mark.parametrize("vals", sorted(SUBNORMAL))
@pytest.mark.parametrize("method", MARGIN)
def test_subnormal_datums_match_jax_bitwise(method, vals, fn):
    """XLA flushes subnormals: |x|^2 of [3e-20, 3e-20] is 0, so no method
    moves a table (torch alone would write +-8.3e18 or +-3e-20); 1e-39
    reads as 0, so its column stays 0.  Label 0 of 2, row 1 the rival."""
    state = (np.zeros((2, 8), np.float32), np.ones((2, 8), np.float32),
             np.zeros(2, np.int32), np.array([False, True]))
    batch = (np.array([[1, 2, 0, 0]], np.int32),
             np.array([SUBNORMAL[vals] + [0.0, 0.0]], np.float32),
             np.zeros(1, np.int32), np.ones(1, np.float32))
    out_j, out_t = run_both(jc.train_scan_impl, getattr(tc, fn), state,
                            batch, method, 1.0)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))
    assert not out_t[0][:, 1].any()
    assert out_t[0][:, 2].any() == (vals == "subnormal_value")


def test_sparse_reads_flush_like_jax():
    """batch_scores (classify) and sample_scores read a subnormal value or
    weight as 0 and flush subnormal products, as XLA does."""
    w = np.array([[0.9, 1e-39, 2.0, -3e-20], [1.0, 4.0, 1e-39, 0.5]],
                 np.float32)
    idx = np.array([[0, 1, 2, 3], [1, 0, 0, 0], [3, 3, 0, 0]], np.int32)
    val = np.array([[1e-39, 5.0, 1e-39, 3e-20], [5.0, 0, 0, 0],
                    [2e-20, 1.0, 0, 0]], np.float32)
    tw, ti, tv = (torch.from_numpy(a) for a in (w, idx, val))
    got = tsparse.batch_scores(tw, ti.long(), tv).numpy()
    want = np.asarray(jsparse.batch_scores(w, idx, val))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[1, 0] == 0.0
    got = tsparse.sample_scores(tw, ti[0].long(), tv[0]).numpy()
    want = np.asarray(jsparse.sample_scores(w, idx[0], val[0]))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("method", ("PA", "AROW"))
def test_classify_of_a_subnormal_datum_is_jax_s(method):
    jd, td, _ = trained_pair(method)
    q = [[], [("x", 1e-39)]]
    jres = jd.classify([JDatum(*q)])
    tres = td.classify([TDatum(*q)])
    assert [sorted(r) for r in tres] == [sorted(r) for r in jres]
    assert all(score == 0.0 for _, score in tres[0])


# ---------------------------------------------------------------------------
# ops, bucketing and the converter copy
# ---------------------------------------------------------------------------

def test_sparse_ops_match_jax():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((5, 64)).astype(np.float32)
    idx = rng.integers(0, 64, (6, 8)).astype(np.int32)
    val = rng.standard_normal((6, 8)).astype(np.float32)
    tw, ti, tv = (torch.from_numpy(a) for a in (w, idx, val))
    np.testing.assert_allclose(
        tsparse.batch_scores(tw, ti.long(), tv).numpy(),
        np.asarray(jsparse.batch_scores(w, idx, val)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsparse.sample_scores(tw, ti[0].long(), tv[0]).numpy(),
        np.asarray(jsparse.sample_scores(w, idx[0], val[0])),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsparse.row_scores(tw[0], ti.long(), tv).numpy(),
        np.asarray(jsparse.row_scores(w[0], idx, val)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsparse.scatter_add_row(tw.clone(), 2, ti[0].long(), tv[0]).numpy(),
        np.asarray(jsparse.scatter_add_row(jnp.asarray(w), 2, idx[0], val[0])),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tsparse.densify(ti, tv, 64).numpy(),
        np.asarray(jsparse.densify(idx, val, 64)), rtol=RTOL, atol=ATOL)


def test_bucketing_matches_jax():
    assert tbucket.B_BUCKETS == jbucket.B_BUCKETS
    for b in (1, 8, 9, 100, 2048, 2049, 8192, 8193, 40000):
        assert tbucket.round_b(b) == jbucket.round_b(b)
    rng = np.random.default_rng(8)
    batches = []
    for b, k in ((3, 16), (5, 32), (2, 16)):
        batches.append((rng.integers(0, 99, (b, k)).astype(np.int32),
                        rng.random((b, k)).astype(np.float32),
                        rng.integers(0, 4, b).astype(np.int32),
                        np.ones(b, np.float32)))
    for a, b in zip(tbucket.fuse_sparse_batches(batches),
                    jbucket.fuse_sparse_batches(batches)):
        np.testing.assert_array_equal(a, b)
    groups = [[1, 2], [], [3, 4, 5]]
    assert tbucket.split_groups(list(range(5)), groups) == \
        jbucket.split_groups(list(range(5)), groups)


CONVERTER_CONFIGS = {
    "bench": config()["converter"],
    "idf_tf": {
        "string_types": {"bigram": {"method": "ngram", "char_num": "2"}},
        "string_rules": [
            {"key": "text", "type": "space", "sample_weight": "tf",
             "global_weight": "idf"},
            {"key": "*", "type": "bigram", "sample_weight": "log_tf",
             "global_weight": "bin"}],
        "num_rules": [{"key": "a*", "type": "log"},
                      {"key": "*", "type": "num"}],
        "hash_max_size": 1 << 10,
    },
}


@pytest.mark.parametrize("name", sorted(CONVERTER_CONFIGS))
def test_converter_matches_jax(name):
    """The port's pure-Python converter lays batches out exactly as the
    JAX package's converter (native packer included) does."""
    cfg = CONVERTER_CONFIGS[name]
    jconv = JConverter(JConverterConfig.from_json(cfg))
    tconv = TConverter(TConverterConfig.from_json(cfg))
    rng = np.random.default_rng(9)
    for _ in range(3):
        recs = []
        for i in range(12):
            words = " ".join(f"t{t}" for t in rng.integers(0, 30, 6))
            recs.append(([("text", words), ("k", f"v{i % 3}")],
                         [("a1", float(rng.random() * 9)),
                          ("b", float(i))]))
        jb = jconv.convert_batch([JDatum(s, n) for s, n in recs],
                                 update_weights=True)
        tb = tconv.convert_batch([TDatum(s, n) for s, n in recs],
                                 update_weights=True)
        np.testing.assert_array_equal(tb.indices, jb.indices)
        np.testing.assert_array_equal(tb.values, jb.values)
    np.testing.assert_array_equal(tconv.weights.df, jconv.weights.df)


# ---------------------------------------------------------------------------
# the whole driver
# ---------------------------------------------------------------------------

def trained_pair(method, seed=1, batches=3, n=40, **param):
    cfg = config(method, **param)
    jd = jc.ClassifierDriver(cfg)
    td = tc.ClassifierDriver(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        recs = stream(rng, n)
        assert jd.train(jdata(recs)) == td.train(tdata(recs)) == n
    return jd, td, rng


@pytest.mark.parametrize("method", MARGIN + CENTROID)
def test_driver_matches_jax(method):
    jd, td, rng = trained_pair(method)
    assert_same_state(jd, td)
    assert td.get_labels() == jd.get_labels()
    q = [TDatum(s, n) for _, s, n in stream(rng, 10)]
    qj = [JDatum(d.string_values, d.num_values) for d in q]
    assert_same_classify(jd.classify(qj), td.classify(q))
    assert td.get_status() == jd.get_status()


@pytest.mark.parametrize("method", ("PA1", "AROW", "NHERD"))
def test_driver_parallel_mode_matches_jax(method):
    jd, td, rng = trained_pair(method, microbatch="parallel")
    assert td.batch_mode == "parallel"
    assert_same_state(jd, td)
    q = [TDatum(s, n) for _, s, n in stream(rng, 6)]
    assert_same_classify(
        jd.classify([JDatum(d.string_values, d.num_values) for d in q]),
        td.classify(q))


def test_label_admin_matches_jax():
    jd, td, rng = trained_pair("AROW", batches=1)
    for d in (jd, td):
        assert d.set_label("extra") is True
        assert d.set_label("extra") is False
        assert d.delete_label("c1") is True
        assert d.delete_label("absent") is False
    recs = stream(rng, 30, n_labels=7)      # c5, c6 are new: c5 reuses c1's row
    jd.train(jdata(recs))
    td.train(tdata(recs))
    assert td.labels == jd.labels
    assert_same_state(jd, td)
    assert td.get_labels() == jd.get_labels()
    for d in (jd, td):
        d.clear()
    assert td.labels == jd.labels == {}
    assert td.capacity == jd.capacity
    assert_same_state(jd, td)


def test_label_growth_past_initial_capacity():
    jd, td, rng = trained_pair("PA1", batches=1)
    recs = stream(rng, 60, n_labels=20)
    jd.train(jdata(recs))
    td.train(tdata(recs))
    assert td.capacity == jd.capacity == 32
    assert_same_state(jd, td)


def test_classify_many_demuxes_like_single_calls():
    _, td, rng = trained_pair("AROW", batches=1)
    groups = [[TDatum(s, n) for _, s, n in stream(rng, k)] for k in (1, 3, 2)]
    many = td.classify_many(groups)
    assert many == [td.classify(g) for g in groups]


def test_get_diff_matches_jax():
    jd, td, _ = trained_pair("AROW", batches=2)
    dj, dt = jd.get_diff(), td.get_diff()
    assert dt["labels"] == dj["labels"]
    np.testing.assert_array_equal(dt["cols"], dj["cols"])
    np.testing.assert_array_equal(dt["counts"], dj["counts"])
    for name in ("w", "cov"):
        np.testing.assert_allclose(dt[name], dj[name], rtol=RTOL, atol=ATOL)
    for key in ("cols", "vals", "doc_count"):
        np.testing.assert_array_equal(dt["weights"][key], dj["weights"][key])


def test_pack_unpack_roundtrip():
    _, td, rng = trained_pair("CW", batches=1)
    q = [TDatum(s, n) for _, s, n in stream(rng, 4)]
    before = td.classify(q)
    fresh = tc.ClassifierDriver(config("CW"), device="cpu")
    fresh.unpack(td.pack())
    assert fresh.classify(q) == before
    assert fresh.get_labels() == td.get_labels()


@pytest.mark.parametrize("bad", [{"method": "nope"},
                                 {"parameter": {"regularization_weight": 0}},
                                 {"parameter": {"microbatch": "sideways"}}])
def test_driver_rejects_bad_config(bad):
    cfg = {**config(), **bad}
    with pytest.raises(ValueError):
        tc.ClassifierDriver(cfg, device="cpu")
