"""The port's regression (jubatus_tpu_torch/models/regression.py and what it
rides on) against the JAX package, on the CPU at a small size.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port.  Tolerances: counts, columns, arena and
wire bytes are exact and must match bitwise; w, diffs and estimates are
float32 sums taken in another order by the two packages, so they agree
within rtol 1e-5 / atol 1e-6.  The seeded streams keep |err| - eps away
from 0 (targets several eps away from any prediction the few steps reach),
where a last-bit difference could flip an update.

Subnormals: XLA flushes float32 subnormals (inputs read as zero, results
flush), and the port's plain versions and reads flush them explicitly
(ops.sparse.ftz; the CUDA kernel is built with -ftz=true).  So at c =
3.4e38 (the reference's shipped PA config) PA2's 0.5 / c, a subnormal, is
0 in both packages, and on the datums [3e-20, 3e-20] (|x|^2 flushes to 0)
and [1e-39, 1.0] (1e-39 reads as 0) the port is bitwise the JAX package.
"""

import io
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from jubatus_tpu.framework import save_load as jsave
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.mix.linear_mixer import encode_wire_diff as jencode
from jubatus_tpu.models import classifier as jc
from jubatus_tpu.models import regression as jr
from jubatus_tpu_torch import native
from jubatus_tpu_torch.framework import save_load as tsave
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff as tencode
from jubatus_tpu_torch.models import classifier as tc
from jubatus_tpu_torch.models import regression as tr
from jubatus_tpu_torch.models.carry import (export_reference_state,
                                            load_reference_state)
from jubatus_tpu_torch.ops import sparse as tsparse
from jubatus_tpu_torch.ops.sparse import ftz

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
METHODS = ("PA", "PA1", "PA2")
BIG_C = 3.4e38            # the shipped PA config's regularization_weight


def config(method="PA", dim=1 << 12, c=1.0, eps=0.1, **param):
    return {
        "method": method,
        "parameter": {"sensitivity": eps, "regularization_weight": c,
                      **param},
        "converter": {
            "string_rules": [{"key": "*", "type": "str",
                              "sample_weight": "bin", "global_weight": "bin"}],
            "num_rules": [{"key": "*", "type": "num"}],
            "hash_max_size": dim,
        },
    }


# ---------------------------------------------------------------------------
# module level: the train step
# ---------------------------------------------------------------------------

def scan_inputs(seed, kind, D=256, B=64, K=16):
    """A microbatch with 9 live entries a datum, padding (index 0, value
    0) after, three padding datums, and targets of +-(2..4) with w small,
    so |err| - eps stays far from 0.  kind "shared": every datum carries
    column 5 (the numeric feature of the smoke's traffic) and a real
    column-0 feature every 7th; kind "dup": columns repeated within a
    datum (twice, and three times)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(D) * 0.01).astype(np.float32)
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    idx[:, 9:] = 0
    val[:, 9:] = 0.0
    if kind == "shared":
        idx[:, 8] = 5
        idx[::7, 0] = 0
    elif kind == "dup":
        idx[::2, 3] = idx[::2, 1]
        idx[::3, 4] = idx[::3, 6] = idx[::3, 2]
    tgt = (rng.choice([-1.0, 1.0], B) * (2 + 2 * rng.random(B))
           ).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    val[20:22] = 0.0                    # not ok: |x|^2 = 0
    return w, (idx, val, tgt, mask)


def run_both(fn, w, batch, method, c, eps=0.1):
    out_j = np.asarray(jr.train_scan_impl(
        jnp.asarray(w), *(jnp.asarray(a) for a in batch), method, c, eps))
    tw = torch.from_numpy(w.copy())
    fn(tw, *(torch.from_numpy(a) for a in batch), method, c, eps)
    return out_j, tw.numpy()


@pytest.mark.parametrize("fn", ("train_scan_ref", "train_scan"))
@pytest.mark.parametrize("kind", ("random", "shared", "dup"))
@pytest.mark.parametrize("method", METHODS)
def test_train_scan_matches_train_scan_impl(method, kind, fn):
    """The plain version, and the wrapper on CPU tensors (which is the
    plain version), against the JAX scan; PA1's C = 0.5 caps some steps."""
    w, batch = scan_inputs(METHODS.index(method), kind)
    out_j, out_t = run_both(getattr(tr, fn), w, batch, method, 0.5)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    assert not np.array_equal(out_t, w)             # it trained
    if kind == "shared":
        assert out_t[5] != w[5]


def test_ftz_flushes_as_xla_does():
    """ftz() against XLA's own flush (a product by a traced 1): every
    subnormal becomes a zero of its sign, the largest subnormal too; the
    smallest normal, zeros, infinities and NaN pass unchanged."""
    tiny = np.finfo(np.float32).tiny
    sub_max = np.nextafter(tiny, np.float32(0))
    x = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, sub_max,
                  -sub_max, tiny, -tiny, 3e-20, -1.0, np.inf, -np.inf,
                  np.nan] * 5, np.float32)
    want = np.asarray(jax.jit(lambda a, one: a * one)(x, np.float32(1.0)))
    got = ftz(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(x))
    ok = ~np.isnan(x)
    np.testing.assert_array_equal(got[ok].view(np.int32),
                                  want[ok].view(np.int32))
    assert (got[:10].view(np.int32) & 0x7fffffff == 0).sum() == 8


def test_pa2_at_the_shipped_regularization_weight():
    w, batch = scan_inputs(7, "shared")
    out_j, out_t = run_both(tr.train_scan_ref, w, batch, "PA2", BIG_C)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    # 0.5 / c is a subnormal, which XLA flushes and the port flushes too
    # (torch alone keeps it) ...
    assert float(jnp.float32(0.5) / jnp.float32(BIG_C)) == 0.0
    half = torch.tensor(0.5) / torch.tensor(BIG_C, dtype=torch.float32)
    assert 0.0 < float(half) < float(np.finfo(np.float32).tiny)
    assert float(ftz(half)) == 0.0
    # ... so PA2 takes PA's step exactly
    _, pa = run_both(tr.train_scan_ref, w, batch, "PA", BIG_C)
    np.testing.assert_array_equal(out_t, pa)


SUBNORMAL = {"tiny_norm": [3e-20, 3e-20], "subnormal_value": [1e-39, 1.0]}


@pytest.mark.parametrize("fn", ("train_scan_ref", "train_scan"))
@pytest.mark.parametrize("c", (1.0, BIG_C))
@pytest.mark.parametrize("vals", sorted(SUBNORMAL))
@pytest.mark.parametrize("method", METHODS)
def test_subnormal_datums_match_jax_bitwise(method, vals, c, fn):
    """XLA flushes subnormals: |x|^2 of [3e-20, 3e-20] is 0, so JAX leaves
    w at 0 (torch alone would write inf, 3e-20 or 5.4e-20); 1e-39 reads as
    0, so its column stays 0 (torch alone would write 9e-40)."""
    w = np.zeros(8, np.float32)
    batch = (np.array([[1, 2, 0, 0]], np.int32),
             np.array([SUBNORMAL[vals] + [0.0, 0.0]], np.float32),
             np.ones(1, np.float32), np.ones(1, np.float32))
    out_j, out_t = run_both(getattr(tr, fn), w, batch, method, c)
    np.testing.assert_array_equal(out_t.view(np.int32), out_j.view(np.int32))
    assert out_t[1] == 0.0
    assert (out_t[2] != 0.0) == (vals == "subnormal_value")


def test_sparse_reads_flush_like_jax():
    """row_scores (estimate) reads a subnormal value or weight as 0 and
    flushes a subnormal product, as XLA does in the jitted _estimate the
    JAX driver runs: there the last product fuses into the sum, and its
    exact -9e-40 flushes to -0 (the op-by-op ops.sparse.row_scores rounds the
    product apart and gives +0)."""
    from jubatus_tpu.models.regression import _estimate
    w = np.array([0.9, 1e-39, 2.0, -3e-20], np.float32)
    idx = np.array([[0, 1, 2, 3], [1, 0, 0, 0], [3, 3, 0, 0]], np.int32)
    val = np.array([[1e-39, 5.0, 1e-39, 3e-20], [5.0, 0, 0, 0],
                    [2e-20, 1.0, 0, 0]], np.float32)
    got = tsparse.row_scores(torch.from_numpy(w), torch.from_numpy(idx)
                             .long(), torch.from_numpy(val)).numpy()
    want = np.asarray(_estimate(jnp.asarray(w), jnp.asarray(idx),
                                jnp.asarray(val)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[:2].any()


def test_estimate_of_a_subnormal_datum_is_jax_s():
    jd, td, _ = trained_pair()
    q = [[("w0", "tok1")], [("x", 1e-39)]], [[], [("x", 1e-39)]]
    got = td.estimate([TDatum(*d) for d in q])
    want = jd.estimate([JDatum(*d) for d in q])
    np.testing.assert_array_equal(np.float32(got), np.float32(want))
    assert got[1] == 0.0


@pytest.mark.parametrize("k", (16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
def test_scan_plan_fits_every_k_bucket(k):
    """Every K bucket of the converter gets a plan within one block's 227 KB
    of shared memory, with T >= 1; the default block holds 1024 entries
    at the 2-slot ring (REG_RING), T is 1 from K 1024 on, and only K 4096
    must give up the second slot."""
    t, s, p = tr.reg_scan_plan(k)
    assert t >= 1 and p == tr.REG_PRODUCERS
    assert tr.reg_scan_smem_bytes(t, s, k) <= tr.REG_SMEM_LIMIT
    assert t == max(1, 1024 // k)
    if k == 4096:
        assert (t, s) == (1, 1)
    else:
        assert s == tr.REG_RING


def test_scan_plan_cuts_the_block_then_the_ring(monkeypatch):
    need = tr.reg_scan_smem_bytes
    p = tr.REG_PRODUCERS
    monkeypatch.setattr(tr, "REG_BLOCK_ENTRIES", 1024)
    monkeypatch.setattr(tr, "REG_RING", 4)
    assert tr.reg_scan_plan(16) == (64, 4, p)      # fits as asked
    # the block first, halved down to one datum, the ring kept
    monkeypatch.setattr(tr, "REG_SMEM_LIMIT", need(64, 4, 16) - 1)
    assert tr.reg_scan_plan(16) == (32, 4, p)
    monkeypatch.setattr(tr, "REG_SMEM_LIMIT", need(2, 4, 16) - 1)
    assert tr.reg_scan_plan(16) == (1, 4, p)
    # then the ring, one slot at a time
    monkeypatch.setattr(tr, "REG_SMEM_LIMIT", need(1, 4, 16) - 1)
    assert tr.reg_scan_plan(16) == (1, 3, p)
    monkeypatch.setattr(tr, "REG_SMEM_LIMIT", need(1, 2, 16) - 1)
    assert tr.reg_scan_plan(16) == (1, 1, p)
    # and nothing where one one-datum slot does not fit
    monkeypatch.setattr(tr, "REG_SMEM_LIMIT", need(1, 1, 16) - 1)
    with pytest.raises(ValueError):
        tr.reg_scan_plan(16)


def test_scan_plan_refuses_a_k_beyond_the_buckets():
    with pytest.raises(ValueError):
        tr.reg_scan_plan(8192)


def test_duplicate_columns_accumulate():
    """A column twice in one datum gets both entries' deltas: w[c] moves by
    sign * tau * (v1 + v2), unlike the classifier's cov, where the last
    occurrence of a column wins."""
    w = np.zeros(8, np.float32)
    idx = np.array([[3, 3, 0, 0]], np.int32)
    val = np.array([[1.0, 2.0, 0.0, 0.0]], np.float32)
    batch = (idx, val, np.array([10.0], np.float32), np.ones(1, np.float32))
    out_j, out_t = run_both(tr.train_scan_ref, w, batch, "PA", 1.0, 0.0)
    # tau = 10 / (1 + 4) = 2; w[3] = 2 * 1 + 2 * 2
    np.testing.assert_array_equal(out_t, out_j)
    assert out_t[3] == 6.0 and not out_t[[0, 1, 2, 4]].any()


def test_sign_is_jnp_sign():
    x = np.array([np.nan, -0.0, 0.0, -2.0, 3.0], np.float32)
    got = tr._sign(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.sign(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_train_scan_wrapper_refuses_other_devices():
    w, batch = scan_inputs(5, "random")
    meta = [torch.from_numpy(a).to("meta") for a in (w, *batch)]
    before = tr.train_scan.launches
    with pytest.raises(ValueError):
        tr.train_scan(*meta, "PA", 1.0, 0.1)
    assert tr.train_scan.launches == before


def test_packed_batch_keeps_float_targets():
    """_pack_batch with float32 targets is the JAX package's blob, and
    _unpack_batch views the per-row lane as float32, not as label rows."""
    _, (idx, val, tgt, mask) = scan_inputs(6, "random")
    packed = tc._pack_batch(idx, val, tgt, mask, per_row_dtype=np.float32)
    np.testing.assert_array_equal(
        packed, jc._pack_batch(idx, val, tgt, mask, per_row_dtype=np.float32))
    views = tc._unpack_batch(torch.from_numpy(packed), *idx.shape,
                             torch.float32)
    assert views[2].dtype == torch.float32
    for a, t in zip((idx, val, tgt, mask), views):
        np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# the whole driver
# ---------------------------------------------------------------------------

def stream(rng, n, vocab=200):
    """n (score, string pairs, number pairs) records shaped like the
    smoke's traffic: the score is a fixed linear function of x and of one
    token's parity, plus noise, and sits several eps from 0."""
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, 5)
        x = float(rng.random())
        y = 3.0 * x + (2.0 if toks[0] % 2 else -2.0) \
            + float(rng.normal(0, 0.1))
        out.append((y, [(f"w{t % 4}", f"tok{t}") for t in toks],
                    [("x", x)]))
    return out


def jdata(records):
    return [(y, JDatum(list(s), list(n))) for y, s, n in records]


def tdata(records):
    return [(y, TDatum(list(s), list(n))) for y, s, n in records]


def queries(rng, n):
    recs = stream(rng, n)
    return ([JDatum(s, v) for _, s, v in recs],
            [TDatum(s, v) for _, s, v in recs])


def trained_pair(method="PA", seed=1, batches=3, n=40, **kw):
    cfg = config(method, **kw)
    jd = jr.RegressionDriver(cfg)
    td = tr.RegressionDriver(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        recs = stream(rng, n)
        assert jd.train(jdata(recs)) == td.train(tdata(recs)) == n
    return jd, td, rng


def assert_same_model(jd, td):
    np.testing.assert_allclose(td.w.numpy(), np.asarray(jd.w), rtol=RTOL,
                               atol=ATOL)
    assert td.num_trained == jd.num_trained
    np.testing.assert_array_equal(td.converter.weights.df,
                                  jd.converter.weights.df)
    assert td.get_status() == jd.get_status()


@pytest.mark.parametrize("method,c", [("PA", 1.0), ("PA1", 0.05),
                                      ("PA2", 1.0), ("PA2", BIG_C)])
def test_driver_matches_jax(method, c):
    jd, td, rng = trained_pair(method, c=c)
    assert_same_model(jd, td)
    qj, qt = queries(rng, 10)
    np.testing.assert_allclose(td.estimate(qt), jd.estimate(qj), rtol=RTOL,
                               atol=ATOL)
    assert td.estimate([]) == jd.estimate([]) == []
    # the read itself is bitwise the JAX package's (ops/sparse.py
    # xla_dot_rows): on the JAX driver's weights the estimates are equal
    td.w = torch.from_numpy(np.asarray(jd.w).copy())
    np.testing.assert_array_equal(
        np.float32(td.estimate(qt)).view(np.uint32),
        np.float32(jd.estimate(qj)).view(np.uint32))


def test_estimate_many_demuxes_like_single_calls():
    _, td, rng = trained_pair(batches=1)
    groups = [queries(rng, k)[1] for k in (1, 3, 2)]
    assert td.estimate_many(groups) == [td.estimate(g) for g in groups]


def raw_frame(mid, records):
    data = [[y, [[list(p) for p in s], [list(p) for p in n], []]]
            for y, s, n in records]
    msg = msgpack.packb([0, mid, "train", ["", data]], use_bin_type=True)
    return msg, native.load().parse_envelope(msg, 0)[4]


def raw_frames(seed, sizes):
    rng = np.random.default_rng(seed)
    return [raw_frame(i, stream(rng, n)) for i, n in enumerate(sizes)]


def test_raw_batch_arena_and_step_match_jax():
    """convert_raw_batch fills the JAX driver's arena byte for byte (mode 1:
    float32 targets in the per-row lane); train_converted_batch then trains
    like the JAX driver's train_raw frame by frame."""
    frames = raw_frames(2, (5, 0, 17, 9))
    jd = jr.RegressionDriver(config())
    td = tr.RegressionDriver(config(), device="cpu")
    tb = td.convert_raw_batch(frames)
    jb = jr.RegressionDriver(config()).convert_raw_batch(frames)
    assert (tb.ns, tb.b, tb.k) == (jb.ns, jb.b, jb.k)
    assert tb.ns == [5, 0, 17, 9] and tb.k == 16
    nbytes = 2 * tb.b * tb.k * 4 + 8 * tb.b
    assert bytes(memoryview(tb.arena)[:nbytes]) == \
        bytes(memoryview(jb.arena)[:nbytes])
    assert td.train_converted_batch(tb) == [5, 0, 17, 9]
    for m, o in frames:
        jd.train_raw(m, o)
    assert_same_model(jd, td)


def test_raw_requests_match_jax():
    """The per-frame raw route (convert_raw_request, train_converted_many
    fusing several, train_raw) against the JAX driver's."""
    frames = raw_frames(3, (4, 0, 11, 6, 3))
    jd = jr.RegressionDriver(config("PA1", c=0.05))
    td = tr.RegressionDriver(config("PA1", c=0.05), device="cpu")
    convs = [td.convert_raw_request(m, o) for m, o in frames[:4]]
    assert convs[1] is None
    assert td.train_converted_many(convs) == [4, 0, 11, 6]
    assert td.train_raw(*frames[4]) == 3
    jconvs = [jd.convert_raw_request(m, o) for m, o in frames[:4]]
    assert jd.train_converted_many(jconvs) == [4, 0, 11, 6]
    jd.train_raw(*frames[4])
    assert_same_model(jd, td)


def test_raw_route_equals_decoded_route():
    """Numeric-only datums lay out alike in the C and Python converters,
    so the raw route trains bitwise like decoded train()."""
    rng = np.random.default_rng(4)
    recs = [(float(rng.normal() * 3), [], [(f"n{j}", float(rng.random()))
                                           for j in range(3)])
            for _ in range(20)]
    raw = tr.RegressionDriver(config(), device="cpu")
    dec = tr.RegressionDriver(config(), device="cpu")
    raw.train_converted_batch(raw.convert_raw_batch([raw_frame(0, recs)]))
    dec.train(tdata(recs))
    assert torch.equal(raw.w, dec.w)


def test_clear_resets_like_jax():
    jd, td, rng = trained_pair(batches=1)
    for d in (jd, td):
        d.clear()
    assert_same_model(jd, td)
    assert not td.w.any() and td.get_diff()["cols"].size == 0
    recs = stream(rng, 12)
    jd.train(jdata(recs))
    td.train(tdata(recs))
    assert_same_model(jd, td)


# ---------------------------------------------------------------------------
# MIX
# ---------------------------------------------------------------------------

def diff_pair(method="PA", seed=5):
    """Two trained replicas in each package; the diffs of the second come
    from a disjoint token range, so cols differ across sides."""
    out = []
    for vocab, s in ((200, seed), (400, seed + 1)):
        cfg = config(method)
        jd = jr.RegressionDriver(cfg)
        td = tr.RegressionDriver(cfg, device="cpu")
        recs = stream(np.random.default_rng(s), 30, vocab=vocab)
        jd.train(jdata(recs))
        td.train(tdata(recs))
        out.append((jd, td))
    return out


def assert_same_diff(tdiff, jdiff):
    assert (tdiff["cols"] is None) == (jdiff["cols"] is None)
    if tdiff["cols"] is not None:
        np.testing.assert_array_equal(tdiff["cols"], jdiff["cols"])
        assert tdiff["dim"] == jdiff["dim"]
    np.testing.assert_allclose(tdiff["w"], jdiff["w"], rtol=RTOL, atol=ATOL)
    assert tdiff["k"] == jdiff["k"]
    for key in ("cols", "vals", "doc_count"):
        np.testing.assert_array_equal(tdiff["weights"][key],
                                      jdiff["weights"][key])


def dense(diff):
    return dict(diff, cols=None, w=jr.RegressionDriver._to_dense_w(diff))


@pytest.mark.parametrize("shape", ("sparse", "dense_rhs", "empty_lhs"))
def test_diff_algebra_matches_jax(shape):
    """get_diff, mix and put_diff over two replicas: col-sparse on both
    sides, one side promoted to full width, and an empty diff (a replica
    that trained nothing)."""
    (j1, t1), (j2, t2) = diff_pair()
    if shape == "empty_lhs":                # a replica that never trained
        j1, t1 = jr.RegressionDriver(config()), \
            tr.RegressionDriver(config(), device="cpu")
    dj = [j1.get_diff(), j2.get_diff()]
    dt = [t1.get_diff(), t2.get_diff()]
    for a, b in zip(dt, dj):
        assert_same_diff(a, b)
    if shape == "empty_lhs":
        assert dt[0]["cols"].size == 0 and dt[0]["w"].size == 0
    if shape == "dense_rhs":
        dj[1], dt[1] = dense(dj[1]), dense(dt[1])
    mj = jr.RegressionDriver.mix(dj[0], dj[1])
    mt = tr.RegressionDriver.mix(dt[0], dt[1])
    assert_same_diff(mt, mj)
    for jd, td in ((j1, t1), (j2, t2)):
        assert jd.put_diff(mj) is td.put_diff(mt) is True
        np.testing.assert_allclose(td.w.numpy(), np.asarray(jd.w),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(td._w_base, jd._w_base, rtol=RTOL,
                                   atol=ATOL)
        assert td._unconfirmed_cols is None and jd._unconfirmed_cols is None
    # replicas of one package end bitwise equal; training goes on from
    # the mixed model without moving the base
    assert torch.equal(t1.w, t2.w)
    base = t1._w_base.copy()
    t1.train(tdata(stream(np.random.default_rng(9), 8)))
    np.testing.assert_array_equal(t1._w_base, base)


def test_unconfirmed_columns_ship_again():
    (_, td), _ = diff_pair()
    first = td.get_diff()
    td.train(tdata(stream(np.random.default_rng(8), 4, vocab=10)))
    second = td.get_diff()                 # no put_diff in between
    assert np.isin(first["cols"], second["cols"]).all()


@pytest.mark.parametrize("payload", ("f32", "int8"))
def test_wire_bytes_match_jax(payload):
    """The v3 (blockwise int8) and v2 (f32) wire bytes of a regression
    diff, and of its int8 transport payload, equal the JAX package's."""
    cfg = config(dcn_payload=payload)
    recs = stream(np.random.default_rng(6), 30)
    jd = jr.RegressionDriver(cfg)
    td = tr.RegressionDriver(cfg, device="cpu")
    jd.train(jdata(recs))
    td.train(tdata(recs))
    # the same diff through both encoders (the trained w agree within
    # tolerance only, so the port's diff feeds both)
    diff = td.get_diff()
    jdiff = dict(diff, weights=dict(diff["weights"]))
    for quantize in (False, True):
        tw = tcodec.packb(tencode(td.encode_diff(diff), quantize, "cpu"))
        jw = jcodec.packb(jencode(jd.encode_diff(jdiff), quantize))
        assert tw == jw
    stats = {}
    back = tcodec.decode(tcodec.unpackb(tcodec.packb(
        tencode(diff, True, "cpu", stats))), "cpu")
    assert np.abs(back["w"] - diff["w"]).max() <= stats["max_abs_err"]
    np.testing.assert_array_equal(back["cols"], diff["cols"])


# ---------------------------------------------------------------------------
# model files and carry
# ---------------------------------------------------------------------------

def _save(mod, driver, cfg):
    buf = io.BytesIO()
    mod.save_model(buf, server_type="regression", model_id="m",
                   config=json.dumps(cfg), user_data_version=1,
                   driver_data=driver.pack())
    return buf.getvalue()


def _load(mod, raw, cfg):
    return mod.load_model(io.BytesIO(raw), server_type="regression",
                          expected_config=json.dumps(cfg),
                          user_data_version=1)


def test_model_files_cross_packages():
    cfg = config("PA1", c=0.05)
    jd, td, rng = trained_pair("PA1", c=0.05)
    qj, qt = queries(rng, 6)
    raw_t, raw_j = _save(tsave, td, cfg), _save(jsave, jd, cfg)
    in_j = jr.RegressionDriver(cfg)
    in_j.unpack(_load(jsave, raw_t, cfg))
    in_t = tr.RegressionDriver(cfg, device="cpu")
    in_t.unpack(_load(tsave, raw_j, cfg))
    np.testing.assert_array_equal(np.asarray(in_j.w), td.w.numpy())
    np.testing.assert_array_equal(in_t.w.numpy(), np.asarray(jd.w))
    assert in_j.num_trained == in_t.num_trained == td.num_trained
    # the same weights: the estimates are bitwise (ops/sparse.py
    # xla_dot_rows sums as XLA's CPU code does)
    bits = lambda e: np.float32(e).view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(bits(in_j.estimate(qj)),
                                  bits(td.estimate(qt)))
    np.testing.assert_array_equal(bits(in_t.estimate(qt)),
                                  bits(jd.estimate(qj)))


def test_unpack_refuses_another_width():
    _, td, _ = trained_pair(batches=1)
    small = tr.RegressionDriver(config(dim=1 << 8), device="cpu")
    with pytest.raises(ValueError, match="dim"):
        small.unpack(td.pack())


def test_carry_roundtrips():
    """A JAX-trained model installed in the port (load_reference_state)
    estimates and keeps training like the JAX driver; the port's exported
    state installs back into a JAX driver unchanged."""
    jd, _, rng = trained_pair("PA2")
    wm = jd.converter.weights
    td = tr.RegressionDriver(config("PA2"), device="cpu")
    load_reference_state(td, {
        "w": np.asarray(jd.w), "num_trained": jd.num_trained,
        "weights": {"df": wm.df, "doc_count": wm.doc_count,
                    "user_weights": wm.user_weights}})
    np.testing.assert_array_equal(td.w.numpy(), np.asarray(jd.w))
    qj, qt = queries(rng, 5)
    np.testing.assert_array_equal(td.estimate(qt), jd.estimate(qj))
    recs = stream(rng, 16)
    jd.train(jdata(recs))
    td.train(tdata(recs))
    assert_same_model(jd, td)
    out = export_reference_state(td)
    back = jr.RegressionDriver(config("PA2"))
    back.unpack({"method": "PA2", "w": out["w"].tobytes(),
                 "num_trained": out["num_trained"],
                 "weights": {"df": out["weights"]["df"].tobytes(),
                             "doc_count": out["weights"]["doc_count"],
                             "user_weights":
                                 out["weights"]["user_weights"].tobytes()}})
    np.testing.assert_array_equal(np.asarray(back.w), td.w.numpy())
    assert back.num_trained == td.num_trained
    with pytest.raises(ValueError, match="dim"):
        load_reference_state(td, {**out, "w": np.zeros(7, np.float32)})


@pytest.mark.parametrize("bad", [{"method": "AROW"},
                                 {"parameter": {"dcn_payload": "int4"}}])
def test_driver_rejects_bad_config(bad):
    cfg = {**config(), **bad}
    with pytest.raises(ValueError):
        tr.RegressionDriver(cfg, device="cpu")
