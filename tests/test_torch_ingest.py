"""The port's native raw train path on the CPU: C conversion into pooled
arenas (models/classifier.convert_raw_batch), the fused device step
(train_converted_batch) and the threads that drive them
(framework/dispatch.IngestPipeline).

  - the fused arena equals the port's decoded path (Python convert_batch
    + fuse_sparse_batches + _pack_batch) byte for byte on datums whose
    feature order both converters share, and the native per-request path
    on any datums; on datums with both string and numeric values the C
    converter lays the string features first and the Python converter the
    numeric ones (both as in the JAX package), so rows hold the same
    (index, value) pairs in another order;
  - the raw path leaves w, cov and counts bitwise equal to the decoded
    train(), and within RTOL / ATOL of the JAX driver's train_raw;
  - an admin op (clear, delete_label, load) between the two stages redoes
    the stale window;
  - arenas recycle per size class, within the bound, and only after the
    pipeline's sync fence;
  - windows of many frames train bitwise like train_raw frame by frame;
  - flush() is a FIFO barrier and raises under the model lock;
  - a bad frame fails its own caller only;
  - the server builds the pipeline only for a config the C code covers.
"""

import threading

import msgpack
import numpy as np
import pytest

from jubatus_tpu_torch import native
from jubatus_tpu_torch.batching.arenas import ArenaPool, pinned_tensor
from jubatus_tpu_torch.batching.bucketing import fuse_sparse_batches, round_b
from jubatus_tpu_torch.batching.controller import WindowController
from jubatus_tpu_torch.framework.dispatch import IngestPipeline
from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.models.classifier import (ClassifierDriver,
                                                 _pack_batch,
                                                 coalesce_sparse_batches)
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError, RWLock
from tests.test_torch_classifier import ATOL, RTOL

BIN = {"sample_weight": "bin", "global_weight": "bin"}
CONV = {"string_rules": [{"key": "*", "type": "str", **BIN}],
        "num_rules": [{"key": "*", "type": "num"}],
        "hash_max_size": 1 << 12}
AROW = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
        "converter": CONV}


def cfg(method="AROW"):
    return dict(AROW, method=method)


def train_frame(mid, rows):
    """A wire train request over (label, tokens, x) rows: one string
    feature w<t%3>=tok<t> per token, one number x unless it is None."""
    data = []
    for lbl, toks, x in rows:
        nums = [] if x is None else [["x", float(x)]]
        data.append([lbl, [[[f"w{t % 3}", f"tok{t}"] for t in toks], nums,
                           []]])
    msg = msgpack.packb([0, mid, "train", ["", data]], use_bin_type=True)
    return msg, native.load().parse_envelope(msg, 0)[4]


def rand_frames(seed, n_frames, numbers=False, empties=True, n_labels=4,
                max_rows=9, label_prefix="l"):
    """Seeded frames whose datums hold 5 to 9 string features (K = 16
    whatever the frame), plus a number when `numbers`."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        n = int(rng.integers(0 if empties else 1, max_rows))
        rows = [(f"{label_prefix}{int(rng.integers(0, n_labels))}",
                 rng.integers(0, 60, int(rng.integers(5, 10))),
                 float(rng.random()) if numbers else None)
                for _ in range(n)]
        frames.append(train_frame(i, rows))
    return frames


def decoded_batches(drv, frames):
    """The decoded route's per-request batches: msgpack decode, Datum
    objects, Python hashing, bucket padding (ClassifierDriver.train)."""
    out = []
    for m, _ in frames:
        data = [(lbl, Datum.from_msgpack(d)) for lbl, d in
                msgpack.unpackb(m, raw=False, strict_map_key=False)[3][1]]
        if not data:
            continue
        rows = [drv._label_row(lbl) for lbl, _ in data]
        batch = drv.converter.convert_batch(
            [d for _, d in data], update_weights=True).pad_to(
                round_b(len(data)))
        b = batch.indices.shape[0]
        labels = np.zeros((b,), np.int32)
        labels[:len(rows)] = rows
        mask = np.zeros((b,), np.float32)
        mask[:len(rows)] = 1.0
        out.append((batch.indices, batch.values, labels, mask))
    return out


def fused_blob(batches):
    fused = batches[0] if len(batches) == 1 else fuse_sparse_batches(batches)
    return _pack_batch(*fused)


def native_batches(drv, frames):
    """The native per-request route's batches (convert_raw_request)."""
    convs = [drv.convert_raw_request(m, o) for m, o in frames]
    return [(c[4], c[5], c[6], c[7]) for c in convs if c[3] > 0]


def arena_bytes(rb):
    return bytes(memoryview(rb.arena)[:2 * rb.b * rb.k * 4 + 8 * rb.b])


def state(drv):
    return [t.numpy().copy() for t in (drv.w, drv.cov, drv.counts)]


def by_label(drv):
    w, cov, counts = state(drv)
    return {lbl: (w[r], cov[r], counts[r]) for lbl, r in drv.labels.items()}


def assert_same_by_label(a, b):
    la, lb = by_label(a), by_label(b)
    assert sorted(la) == sorted(lb)
    for lbl in la:
        for x, y in zip(la[lbl], lb[lbl]):
            np.testing.assert_array_equal(x, y, err_msg=lbl)


# ---------------------------------------------------------------------------
# arenas: the fused native arena against the decoded and per-request routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_frames", [1, 2, 7, 16])
def test_arena_equals_the_decoded_path_bitwise(n_frames):
    frames = rand_frames(n_frames, n_frames, empties=n_frames > 2)
    ref = ClassifierDriver(AROW, device="cpu")
    want = fused_blob(decoded_batches(ref, frames))
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch(frames)
    assert arena_bytes(rb) == want.tobytes()
    assert drv.labels == ref.labels
    assert rb.ns == [len(msgpack.unpackb(m)[3][1]) for m, _ in frames]


@pytest.mark.parametrize("n_frames", [1, 5, 16])
def test_arena_equals_the_native_per_request_path_bitwise(n_frames):
    frames = rand_frames(30 + n_frames, n_frames, numbers=True)
    ref = ClassifierDriver(AROW, device="cpu")
    want = fused_blob(native_batches(ref, frames))
    drv = ClassifierDriver(AROW, device="cpu")
    assert arena_bytes(drv.convert_raw_batch(frames)) == want.tobytes()
    assert drv.labels == ref.labels


def test_mixed_datums_hold_the_decoded_pairs_in_another_order():
    frames = rand_frames(4, 5, numbers=True, empties=False)
    ref = ClassifierDriver(AROW, device="cpu")
    idx_d, val_d, lab_d, msk_d = fuse_sparse_batches(
        decoded_batches(ref, frames))
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch(frames)
    b, k = rb.b, rb.k
    assert (b, k) == idx_d.shape
    idx = np.frombuffer(rb.arena, np.int32, count=b * k).reshape(b, k)
    val = np.frombuffer(rb.arena, np.float32, count=b * k,
                        offset=b * k * 4).reshape(b, k)
    lab = np.frombuffer(rb.arena, np.int32, count=b, offset=8 * b * k)
    msk = np.frombuffer(rb.arena, np.float32, count=b,
                        offset=8 * b * k + 4 * b)
    np.testing.assert_array_equal(lab, lab_d)
    np.testing.assert_array_equal(msk, msk_d)
    reordered = 0
    for r in range(b):
        live = val_d[r] != 0
        got = dict(zip(idx[r][val[r] != 0].tolist(),
                       val[r][val[r] != 0].tolist()))
        want = dict(zip(idx_d[r][live].tolist(), val_d[r][live].tolist()))
        assert got.keys() == want.keys()
        for i in want:
            assert got[i] == pytest.approx(want[i], rel=1e-6)
        reordered += not np.array_equal(idx[r], idx_d[r])
    assert reordered > 0


def test_empty_window_and_alias():
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch([train_frame(i, []) for i in range(3)])
    assert (rb.ns, rb.b, rb.arena) == ([0, 0, 0], 0, None)
    assert drv.train_converted_batch(rb) == [0, 0, 0]
    assert coalesce_sparse_batches is fuse_sparse_batches


def test_unknown_labels_across_frames_share_rows():
    frames = [train_frame(0, [("new_a", [1, 2], None)]),
              train_frame(1, [("new_b", [3, 4], None)]),
              train_frame(2, [("new_a", [5], None), ("new_b", [6], None)])]
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch(frames)
    lab = np.frombuffer(rb.arena, np.int32, count=rb.b,
                        offset=2 * rb.b * rb.k * 4)
    ra, rb_ = drv.labels["new_a"], drv.labels["new_b"]
    assert (lab[0], lab[8], lab[16], lab[17]) == (ra, rb_, ra, rb_)


def test_rows_past_capacity_grow_in_stage_two():
    frames = rand_frames(8, 3, n_labels=20, empties=False, max_rows=12)
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch(frames)
    assert rb.need > drv.capacity == ClassifierDriver.INITIAL_CAPACITY
    drv.train_converted_batch(rb)
    assert drv.capacity >= rb.need
    assert sum(drv.get_labels().values()) == rb.total


# ---------------------------------------------------------------------------
# model state: raw path vs decoded path vs the JAX driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["AROW", "PA1", "CW", "perceptron",
                                    "cosine"])
def test_raw_path_state_bitwise_equal_to_decoded_train(method):
    frames = rand_frames(11, 12)
    dec = ClassifierDriver(cfg(method), device="cpu")
    for m, _ in frames:
        data = msgpack.unpackb(m, raw=False)[3][1]
        dec.train([(lbl, Datum.from_msgpack(d)) for lbl, d in data])
    raw = ClassifierDriver(cfg(method), device="cpu")
    for s in range(0, len(frames), 5):
        raw.train_converted_batch(raw.convert_raw_batch(frames[s:s + 5]))
    assert raw.labels == dec.labels
    for a, b in zip(state(raw), state(dec)):
        np.testing.assert_array_equal(a, b)
    assert float(np.abs(raw.w.numpy()).max()) > 0


@pytest.mark.parametrize("method", ["AROW", "PA2", "NHERD"])
def test_raw_path_close_to_the_jax_driver(method):
    from jubatus_tpu.models.classifier import ClassifierDriver as JaxDriver
    frames = rand_frames(12, 10, numbers=True)
    jdrv = JaxDriver(cfg(method))
    for m, o in frames:
        jdrv.train_raw(m, o)
    raw = ClassifierDriver(cfg(method), device="cpu")
    for s in range(0, len(frames), 4):
        raw.train_converted_batch(raw.convert_raw_batch(frames[s:s + 4]))
    assert raw.labels == jdrv.labels
    np.testing.assert_array_equal(raw.counts.numpy(), np.asarray(jdrv.counts))
    np.testing.assert_allclose(raw.w.numpy(), np.asarray(jdrv.w),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(raw.cov.numpy(), np.asarray(jdrv.cov),
                               rtol=RTOL, atol=ATOL)


def test_train_raw_and_per_request_stages_match_the_fused_path():
    frames = rand_frames(13, 9, numbers=True)
    fused = ClassifierDriver(AROW, device="cpu")
    fused.train_converted_batch(fused.convert_raw_batch(frames))
    one = ClassifierDriver(AROW, device="cpu")
    for m, o in frames:
        one.train_raw(m, o)
    two = ClassifierDriver(AROW, device="cpu")
    two.train_converted_many([two.convert_raw_request(m, o)
                              for m, o in frames])
    for drv in (one, two):
        for a, b in zip(state(drv), state(fused)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# admin ops between the stages: the stale window is redone
# ---------------------------------------------------------------------------

def test_clear_between_stages_redoes_the_window():
    drv = ClassifierDriver(AROW, device="cpu")
    drv.train_converted_batch(drv.convert_raw_batch(rand_frames(1, 4)))
    frames = rand_frames(2, 6, label_prefix="m")
    rb = drv.convert_raw_batch(frames)
    drv.clear()
    assert rb.gen != drv._fast_gen
    assert drv.train_converted_batch(rb) == rb.ns
    ref = ClassifierDriver(AROW, device="cpu")
    ref.train_converted_batch(ref.convert_raw_batch(frames))
    assert_same_by_label(drv, ref)


def test_delete_label_between_stages_redoes_the_window():
    first = rand_frames(3, 4, empties=False)
    frames = rand_frames(4, 5, empties=False, label_prefix="n")
    drv = ClassifierDriver(AROW, device="cpu")
    drv.train_converted_batch(drv.convert_raw_batch(first))
    rb = drv.convert_raw_batch(frames)
    assert drv.delete_label("l1")
    assert rb.gen != drv._fast_gen
    drv.train_converted_batch(rb)
    ref = ClassifierDriver(AROW, device="cpu")
    ref.train_converted_batch(ref.convert_raw_batch(first))
    ref.delete_label("l1")
    for m, o in frames:
        ref.train_raw(m, o)
    assert "l1" not in drv.labels
    assert_same_by_label(drv, ref)


def test_delete_of_a_label_interned_by_a_pending_window():
    drv = ClassifierDriver(AROW, device="cpu")
    rb = drv.convert_raw_batch([train_frame(0, [
        (f"z{i}", [i, 1, 2, 3, 4], None) for i in range(12)])])
    late = max(drv.labels, key=drv.labels.get)
    assert drv.labels[late] >= drv.capacity       # no device state yet
    assert drv.delete_label(late)
    drv.train_converted_batch(rb)                 # redone: late comes back
    assert drv.get_labels()[late] > 0


def test_load_between_stages_redoes_the_window():
    saved = ClassifierDriver(AROW, device="cpu")
    saved.train_converted_batch(saved.convert_raw_batch(rand_frames(6, 5)))
    obj = saved.pack()
    frames = rand_frames(7, 5, label_prefix="q")
    drv = ClassifierDriver(AROW, device="cpu")
    drv.train_converted_batch(drv.convert_raw_batch(rand_frames(8, 3)))
    rb = drv.convert_raw_batch(frames)
    drv.unpack(obj)
    drv.train_converted_batch(rb)
    ref = ClassifierDriver(AROW, device="cpu")
    ref.unpack(obj)
    for m, o in frames:
        ref.train_raw(m, o)
    assert_same_by_label(drv, ref)


# ---------------------------------------------------------------------------
# arena pool
# ---------------------------------------------------------------------------

def test_pool_recycles_per_size_class():
    pool = ArenaPool(max_per_size=2)
    a = pool.acquire(1000)
    assert a.nbytes == 4096 and a.dtype == np.uint8
    assert a.ctypes.data % 64 == 0 and a.flags.writeable
    pool.release(a)
    assert pool.acquire(500) is a                     # same 4 KB class
    c = pool.acquire(100_000)                         # another class
    assert c is not a and c.nbytes == 102400
    assert (pool.hits, pool.misses) == (1, 2)
    assert pinned_tensor(a) is None                   # plain host memory


def test_pool_bound_and_disable():
    pool = ArenaPool(max_per_size=1)
    a, b = pool.acquire(64), pool.acquire(64)
    pool.release(a)
    pool.release(b)                                   # over the bound
    assert pool.free_arenas() == 1
    off = ArenaPool(max_per_size=0)
    off.release(off.acquire(64))
    assert off.free_arenas() == 0
    off.acquire(64)
    assert (off.hits, off.misses) == (0, 2)


def test_each_driver_owns_its_pool():
    a = ClassifierDriver(AROW, device="cpu")
    b = ClassifierDriver(AROW, device="cpu")
    assert a.arena_pool is not b.arena_pool and not a.arena_pool.pinned
    rb = a.convert_raw_batch(rand_frames(2, 2, empties=False))
    assert (a.arena_pool.misses, b.arena_pool.misses) == (1, 0)
    assert isinstance(rb.arena, np.ndarray) and rb.arena.ctypes.data % 64 == 0


class _Server:
    """The slot surface the dispatchers use."""

    def __init__(self, drv):
        self.model_lock = RWLock()
        self.driver = drv
        self.update_count = 0

    def event_model_updated(self):
        self.update_count += 1


def test_pipeline_releases_arenas_only_after_the_sync_fence(monkeypatch):
    drv = ClassifierDriver(cfg("PA1"), device="cpu")
    events = []
    pool = drv.arena_pool
    real_release, real_step = pool.release, drv.train_converted_batch

    def release(arena):
        events.append(("release", id(arena)))
        real_release(arena)

    def step(rb):
        events.append(("step", id(rb.arena)))
        return real_step(rb)

    monkeypatch.setattr(pool, "release", release)
    monkeypatch.setattr(drv, "train_converted_batch", step)
    monkeypatch.setattr(drv, "device_sync",
                        lambda: events.append(("sync", None)))
    hits0, miss0 = pool.hits, pool.misses
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    try:
        for r in range(6 * IngestPipeline.SYNC_EVERY):
            m, o = train_frame(r, [("l0", [r % 5, 7, 9, 11, 13], None)])
            assert pipe.submit(m, o).result(timeout=30) == 1
        pipe.flush()
    finally:
        pipe.stop()
    stepped, synced = set(), set()
    released = 0
    for kind, key in events:
        if kind == "step":
            stepped.add(key)
        elif kind == "sync":
            synced |= stepped
        else:
            assert key in synced, "an arena went back before its fence"
            released += 1
    assert released == 5 * IngestPipeline.SYNC_EVERY + \
        IngestPipeline.SYNC_EVERY
    assert pool.hits - hits0 > 0
    # one request in flight at a time: at most SYNC_EVERY + 1 arenas ever
    assert pool.misses - miss0 <= IngestPipeline.SYNC_EVERY + 1
    assert srv.update_count == 6 * IngestPipeline.SYNC_EVERY


# ---------------------------------------------------------------------------
# pipeline threads
# ---------------------------------------------------------------------------

def test_pipeline_trains_bitwise_like_the_fused_path():
    frames = rand_frames(21, 24, numbers=True)
    drv = ClassifierDriver(AROW, device="cpu")
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    try:
        futs = [pipe.submit(m, o) for m, o in frames]
        ns = [f.result(timeout=60) for f in futs]
        pipe.flush()
    finally:
        pipe.stop()
    ref = ClassifierDriver(AROW, device="cpu")
    for m, o in frames:
        ref.train_raw(m, o)
    assert ns == [len(msgpack.unpackb(m)[3][1]) for m, _ in frames]
    assert drv.labels == ref.labels
    for a, b in zip(state(drv), state(ref)):
        np.testing.assert_array_equal(a, b)
    assert srv.update_count == len(frames)


@pytest.mark.parametrize("method", ["AROW", "PA1", "CW"])
def test_fused_windows_train_bitwise_like_train_raw(method):
    """The pipeline at its default window (MAX_COALESCE frames, the
    adaptive linger): frames queued behind a held model lock fuse into
    windows of many frames, and the state equals train_raw frame by
    frame."""
    frames = rand_frames(40, 3 * IngestPipeline.MAX_COALESCE, numbers=True)
    drv = ClassifierDriver(cfg(method), device="cpu")
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    try:
        with srv.model_lock.write():     # hold the dispatch stage
            futs = [pipe.submit(m, o) for m, o in frames]
        ns = [f.result(timeout=60) for f in futs]
        pipe.flush()
    finally:
        pipe.stop()
    assert pipe.frames == len(frames)
    assert pipe.windows < pipe.frames     # some window held many frames
    ref = ClassifierDriver(cfg(method), device="cpu")
    assert ns == [ref.train_raw(m, o) for m, o in frames]
    assert drv.labels == ref.labels
    for a, b in zip(state(drv), state(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["pipeline"])
def test_flush_is_a_fifo_barrier(kind):
    drv = ClassifierDriver(cfg("PA"), device="cpu")
    srv = _Server(drv)
    frames = rand_frames(0, 10, empties=False)
    d = IngestPipeline(srv)
    try:
        futs = [d.submit(m, o) for m, o in frames]
        d.flush()
        assert all(f.done() for f in futs)
        assert srv.update_count == 10
    finally:
        d.stop()


@pytest.mark.parametrize("kind", ["pipeline"])
def test_flush_under_the_model_lock_raises(kind):
    srv = _Server(ClassifierDriver(cfg("PA"), device="cpu"))
    d = IngestPipeline(srv)
    try:
        with srv.model_lock.write():
            with pytest.raises(LockDisciplineError, match="write lock"):
                d.flush()
        with srv.model_lock.read():
            with pytest.raises(LockDisciplineError, match="read lock"):
                d.flush()
        d.flush()                        # legal outside the lock
    finally:
        d.stop()


def test_bad_frame_fails_only_its_caller():
    drv = ClassifierDriver(cfg("PA"), device="cpu")
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    try:
        good1 = train_frame(0, [("l0", [1, 2], None)])
        bad_msg = msgpack.packb([0, 1, "train", ["", 42]])
        good2 = train_frame(2, [("l1", [3], None)])
        # hold the dispatch stage so the three frames share a window
        with srv.model_lock.write():
            futs = [pipe.submit(*good1), pipe.submit(bad_msg, 9),
                    pipe.submit(*good2)]
        assert futs[0].result(timeout=30) == 1
        assert futs[2].result(timeout=30) == 1
        with pytest.raises(ValueError, match="malformed params"):
            futs[1].result(timeout=30)
        assert srv.update_count == 2
        assert drv.get_labels() == {"l0": 1, "l1": 1}
    finally:
        pipe.stop()


def test_stalls_count_when_the_device_stage_lags(monkeypatch):
    monkeypatch.setattr(IngestPipeline, "MAX_COALESCE", 1)
    monkeypatch.setattr(IngestPipeline, "DEPTH", 1)
    drv = ClassifierDriver(cfg("PA"), device="cpu")
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    try:
        with srv.model_lock.write():       # the dispatch stage waits
            futs = [pipe.submit(*train_frame(i, [("l0", [i], None)]))
                    for i in range(5)]
            for _ in range(200):
                if pipe.stalls:
                    break
                threading.Event().wait(0.01)
        for f in futs:
            f.result(timeout=30)
    finally:
        pipe.stop()
    assert pipe.stalls > 0


def test_rwlock_ownership_and_window_controller():
    lock = RWLock()
    assert not lock.write_held_by_me() and not lock.read_held_by_me()
    with lock.write():
        assert lock.write_held_by_me()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            lock.write_held_by_me()))
        t.start()
        t.join()
        assert seen == [False]
    with lock.read():
        assert lock.read_held_by_me()
    assert not lock.read_held_by_me()
    ctl = WindowController(max_wait_s=0.002, target_batch=8)
    assert ctl.wait_s == 0.0
    for _ in range(30):
        ctl.observe(16)
    assert ctl.wait_s == pytest.approx(0.002)
    for _ in range(60):
        ctl.observe(1)
    assert ctl.wait_s < 1e-4


def test_concurrent_trains_reads_and_admin_ops_lose_no_update():
    """Stress, with a shortened switch interval: 12 client threads push raw
    frames through the pipeline while a reader classifies under the read
    lock and an admin thread flushes and sets labels under the write lock.
    Every acked datum is counted exactly once."""
    import sys
    drv = ClassifierDriver(cfg("PA1"), device="cpu")
    srv = _Server(drv)
    pipe = IngestPipeline(srv)
    acked, errors, done = [], [], threading.Event()

    def client(t):
        try:
            for m, o in rand_frames(100 + t, 5, empties=False, max_rows=4):
                acked.append(pipe.submit(m, o).result(timeout=60))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def reader():
        q = [Datum().add_string("w0", "tok1")]
        while not done.wait(0.001):
            with srv.model_lock.read():
                drv.classify(q)
                drv.get_labels()

    def admin():
        for i in range(5):
            pipe.flush()
            with srv.model_lock.write():
                drv.set_label(f"extra{i}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        clients = [threading.Thread(target=client, args=(t,))
                   for t in range(12)]
        others = [threading.Thread(target=reader),
                  threading.Thread(target=admin)]
        for th in clients + others:
            th.start()
        for th in clients + others[1:]:
            th.join(timeout=120)
        done.set()
        others[0].join(timeout=30)
        assert not any(th.is_alive() for th in clients + others)
        pipe.flush()
    finally:
        sys.setswitchinterval(old)
        pipe.stop()
    assert not errors
    assert len(acked) == 60
    labels = drv.get_labels()
    assert sum(labels.values()) == sum(acked) > 0
    assert all(labels[f"extra{i}"] == 0 for i in range(5))
    assert srv.update_count == 60


@pytest.mark.parametrize("eligible", [True, False])
def test_server_builds_the_pipeline_only_for_a_covered_config(eligible):
    """The port's server: an IngestPipeline in front of the driver when
    the C converter covers the config, none (the decoded route) when it
    does not; get_status reports the route and the fixed settings."""
    import json
    from jubatus_tpu_torch.framework.server_base import (JubatusServer,
                                                         ServerArgs)
    from jubatus_tpu_torch.framework.service import bind_service
    from jubatus_tpu_torch.rpc.server import RpcServer
    conf = json.loads(json.dumps(AROW))
    if not eligible:      # a regex key matcher: the C code does not cover it
        conf["converter"]["string_rules"] = [{"key": "/^w[0-2]$/",
                                              "type": "str", **BIN}]
    srv = JubatusServer(ServerArgs(type="classifier", name="t", rpc_port=0,
                                   device="cpu"), config=json.dumps(conf))
    bind_service(srv, RpcServer())
    try:
        (st,) = srv.get_status().values()
        assert (srv.dispatcher is not None) is eligible
        assert (st["fast_path"], st["ingest_pipeline"]) == \
            (str(eligible), str(int(eligible)))
        assert (st["batch_max"], st["ingest_depth"], st["arena_pool"],
                st["dispatch_mode"]) == ("16", "2", "4", "threaded")
        assert ("ingest_windows" in st) is eligible
    finally:
        srv.stop()
