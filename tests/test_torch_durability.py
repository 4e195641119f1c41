"""The port's durability plane (jubatus_tpu_torch/durability/) against the
JAX package's (jubatus_tpu/durability/), both in this process on the CPU.

- The journal, case by case in both packages: round trip, rotation, torn
  tail, mid-file corruption, resume, the header's round; and the same
  records give byte-equal segment files from either package's Journal.
- Recovery in the port: wire trains through the ingest pipeline, a
  snapshot, more trains, then a restart on the same directory gives a
  model bitwise equal to an uncrashed driver fed the same frames; a
  corrupt newest snapshot falls back; a journaled diff replays through
  the round guard; clear replays; the directory is locked; an errored
  replay pins the truncation floor and suspends snapshots; a kernel that
  fails during replay fails the boot.
- Across packages, both ways: a directory one package wrote is recovered
  by the other to the writer's own recovery, within rtol 1e-5 / atol
  1e-6 for floats, labels and counts exact.
- The WAL root's layout, the durable save(), get_status.
- A gossip round's pulled fold (random_mixer): journaled as the JAX
  mixer's record, bytes equal; after SIGKILL the port's recovery and the
  JAX package's of the directory agree.

Every wait has its own timeout."""

import json
import os
import shutil
import signal
import socket
import sys
import time

import msgpack
import numpy as np
import pytest

from jubatus_tpu.durability import journal as jjournal
from jubatus_tpu.framework import server_base as jserver_base
from jubatus_tpu.framework import service as jservice
from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.utils.metrics import Registry as JRegistry
from jubatus_tpu_torch import native
from jubatus_tpu_torch.cli.server import serve
from jubatus_tpu_torch.cluster.membership import (MEMBERS_TTL_S,
                                                  MembershipClient)
from jubatus_tpu_torch.durability import journal as tjournal
from jubatus_tpu_torch.durability.snapshotter import Manifest
from jubatus_tpu_torch.framework import server_base as tserver_base
from jubatus_tpu_torch.framework import service as tservice
from jubatus_tpu_torch.kernels.build import KernelError
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.rpc.client import Client as tclient
from jubatus_tpu_torch.utils.metrics import Registry as TRegistry
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_wire_golden import datum_wire

CONVERTER = {
    "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
    "hash_max_size": 4096,
}
CONFIGS = {
    "classifier": {"method": "PA", "parameter": {}, "converter": CONVERTER},
    "regression": {"method": "PA",
                   "parameter": {"sensitivity": 0.1,
                                 "regularization_weight": 1.0},
                   "converter": CONVERTER},
}
JOURNALS = {"jax": jjournal, "port": tjournal}
REGISTRIES = {"jax": JRegistry, "port": TRegistry}
SERVER_BASES = {"jax": jserver_base, "port": tserver_base}
CODECS = {"jax": jcodec, "port": tcodec}
SERVICE_TABLES = {"jax": jservice.SERVICES, "port": tservice.SERVICES}
WAIT_S = 30


def wait_until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout} s")
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# helpers: servers of either package, updates as the live handlers apply them
# ---------------------------------------------------------------------------


def make_server(pkg, service, dirpath, **kw):
    """A server of `pkg` ("jax" or "port", the port on --device cpu) on
    the journal directory `dirpath`, recovered and journaling."""
    base = SERVER_BASES[pkg]
    kw.setdefault("journal_fsync", "always")
    kw.setdefault("snapshot_interval_sec", 0.0)
    if pkg == "port":
        kw.setdefault("device", "cpu")
    args = base.ServerArgs(type=service, name="t", journal_dir=str(dirpath),
                           **kw)
    srv = base.JubatusServer(args, config=json.dumps(CONFIGS[service]))
    srv.init_durability()
    return srv


def shut(pkg, srv):
    if pkg == "jax":
        srv.shutdown_durability()
    else:
        srv.stop()


def rows_wire(service, rows):
    """[(label, token, x)] -> the train RPC's wire argument."""
    if service == "classifier":
        return [[lbl, datum_wire(strings=[("k", tok)], nums=[("x", x)])]
                for lbl, tok, x in rows]
    return [[float(len(lbl)) + x, datum_wire(strings=[("k", tok)],
                                             nums=[("x", x)])]
            for lbl, tok, x in rows]


def train_u(pkg, srv, service, rows, round_=None):
    """Apply and journal one decoded train update the way wrap() does."""
    data = rows_wire(service, rows)
    with srv.model_lock.write():
        SERVICE_TABLES[pkg][service].methods["train"].fn(srv, data)
        srv.event_model_updated()
        srv.journal.append({"k": "u", "m": "train", "a": [data]},
                           srv.current_mix_round() if round_ is None
                           else round_)
    srv.journal.commit()


def train_frames(service, seed, n_frames=3, per=4):
    """Raw train request frames (as a client sends them)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        rows = [(f"l{int(rng.integers(3))}", f"t{int(rng.integers(50))}",
                 float(rng.normal())) for _ in range(per)]
        frames.append(msgpack.packb([0, i + 1, "train",
                                     ["t", rows_wire(service, rows)]],
                                    use_bin_type=True))
    return frames


def train_raw_record(pkg, srv, frames):
    """Apply and journal a fused raw-train window the way the ingest
    pipeline does (one step over the frames, one `train` record)."""
    drv = srv.driver
    offs = [native.load().parse_envelope(m, 0)[4] for m in frames]
    with srv.model_lock.write():
        if pkg == "jax":
            drv.train_converted_many([drv.convert_raw_request(m, o)
                                      for m, o in zip(frames, offs)])
        else:
            drv.train_converted_batch(
                drv.convert_raw_batch(list(zip(frames, offs))))
        srv.journal.append({"k": "train",
                            "f": [[m, o] for m, o in zip(frames, offs)]},
                           srv.current_mix_round())
    srv.journal.commit()


def diff_payload(pkg, service, rows, round_, quantize=False):
    """A scatter payload shaped like the master's put_diff argument,
    from a donor driver of `pkg` trained on `rows`."""
    base = SERVER_BASES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    donor = base.JubatusServer(base.ServerArgs(type=service, name="d", **kw),
                               config=json.dumps(CONFIGS[service]))
    SERVICE_TABLES[pkg][service].methods["train"].fn(
        donor, rows_wire(service, rows))
    diff = donor.driver.encode_diff(donor.driver.get_diff_snapshot())
    if quantize:
        from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
        body, version = encode_wire_diff(diff, True, "cpu"), 3
    else:
        body, version = CODECS[pkg].encode(diff), 2
    # through the wire's msgpack, as a put_diff handler receives it
    return msgpack.unpackb(msgpack.packb(
        {"protocol_version": version, "round": round_, "diff": body},
        use_bin_type=True), raw=False)


def put_diff_record(pkg, srv, packed, round_):
    """The put_diff handler's apply + journal critical section."""
    codec = CODECS[pkg]
    with srv.model_lock.write():
        obj = codec.decode(packed, "cpu") if pkg == "port" \
            else codec.decode(packed)
        srv.driver.put_diff(obj["diff"])
        srv._recovered_round = round_
        srv.journal.append({"k": "diff", "p": packed}, round_)
    srv.journal.commit()


def packed(srv) -> bytes:
    return msgpack.packb(srv.driver.pack(), use_bin_type=True)


def tables(service, pack):
    """A driver's pack as {key: array}, rows keyed by label."""
    if service == "regression":
        return {"w": np.frombuffer(pack["w"], np.float32)}
    labels = {(k.decode() if isinstance(k, bytes) else k): int(v)
              for k, v in pack["labels"].items()}
    cap, dim = int(pack["capacity"]), int(pack["dim"])
    w = np.frombuffer(pack["w"], np.float32).reshape(cap, dim)
    counts = np.frombuffer(pack["counts"], np.int32)
    out = {f"w:{lbl}": w[row] for lbl, row in labels.items()}
    out.update({f"count:{lbl}": counts[row:row + 1]
                for lbl, row in labels.items()})
    return out


def assert_close_models(service, a, b):
    ta, tb = tables(service, a), tables(service, b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        if k.startswith("count:"):
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        else:
            np.testing.assert_allclose(ta[k], tb[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the journal, in both packages
# ---------------------------------------------------------------------------

PKGS = ["jax", "port"]


def journal_of(pkg, path, **kw):
    kw.setdefault("fsync", "off")
    return JOURNALS[pkg].Journal(str(path), registry=REGISTRIES[pkg](), **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_append_read_roundtrip(pkg, tmp_path):
    j = journal_of(pkg, tmp_path, fsync="always")
    recs = [{"k": "u", "m": "train", "a": [[["A", [[["k", "x"]], [], []]]]]},
            {"k": "clear"},
            {"k": "train", "f": [[b"\x00\xffraw", 17]]}]
    assert [j.append(r) for r in recs] == [0, 1, 2]
    j.commit()
    j.close()
    got = list(JOURNALS[pkg].iter_records(str(tmp_path)))
    assert [(pos, rnd) for pos, rnd, _ in got] == [(0, 0), (1, 0), (2, 0)]
    assert [r for _, _, r in got] == [
        recs[0], recs[1], {"k": "train", "f": [[b"\x00\xffraw", 17]]}]


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_rotation_keeps_positions_continuous(pkg, tmp_path):
    j = journal_of(pkg, tmp_path, segment_bytes=4096)
    for i in range(40):
        j.append({"k": "u", "m": "x", "a": ["y" * 300, i]})
        j.commit()                       # rotation runs in commit()
    j.close()
    segs = JOURNALS[pkg].scan_segments(str(tmp_path))
    assert len(segs) > 2
    got = list(JOURNALS[pkg].iter_records(str(tmp_path)))
    assert [pos for pos, _, _ in got] == list(range(40))
    assert [r["a"][1] for _, _, r in got] == list(range(40))


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_torn_tail_tolerated_and_truncated(pkg, tmp_path):
    j = journal_of(pkg, tmp_path)
    for i in range(3):
        j.append({"k": "u", "m": "x", "a": [i]})
    j.commit()
    j.close()
    (seg,) = JOURNALS[pkg].scan_segments(str(tmp_path))
    good = os.path.getsize(seg)
    with open(seg, "ab") as fp:
        fp.write(b"\x00\x00\x01\x00\xde\xad")      # a frame cut short
    recs, torn, valid = JOURNALS[pkg].read_segment(seg)
    assert torn and valid == good and len(recs) == 4   # header + 3
    got = list(JOURNALS[pkg].iter_records(str(tmp_path), truncate_torn=True))
    assert [r["a"][0] for _, _, r in got] == [0, 1, 2]
    assert os.path.getsize(seg) == good


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_mid_file_corruption_stops_scan(pkg, tmp_path):
    j = journal_of(pkg, tmp_path)
    for i in range(4):
        j.append({"k": "u", "m": "x", "a": [i]})
    j.commit()
    j.close()
    (seg,) = JOURNALS[pkg].scan_segments(str(tmp_path))
    frames, off = [], 0
    data = bytearray(open(seg, "rb").read())
    while off < len(data):
        n = int.from_bytes(data[off:off + 4], "big")
        frames.append(off)
        off += 8 + n
    data[frames[2] + 9] ^= 0xFF          # a payload byte of record 1
    open(seg, "wb").write(bytes(data))
    recs, torn, valid = JOURNALS[pkg].read_segment(seg)
    assert torn and valid == frames[2]
    assert [r["a"][0] for r in recs[1:]] == [0]


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_resume_continues_positions(pkg, tmp_path):
    j = journal_of(pkg, tmp_path)
    for i in range(3):
        j.append({"k": "u", "m": "x", "a": [i]})
    j.commit()
    j.close()
    infos = [i for i, _ in JOURNALS[pkg].scan_segment_records(str(tmp_path))]
    j2 = journal_of(pkg, tmp_path, start_position=infos[-1].end,
                    start_seq=infos[-1].seq + 1, retained=infos)
    assert j2.append({"k": "u", "m": "x", "a": [3]}) == 3
    j2.commit()
    j2.close()
    got = list(JOURNALS[pkg].iter_records(str(tmp_path)))
    assert [(p, r["a"][0]) for p, _, r in got] == [(i, i) for i in range(4)]


@pytest.mark.parametrize("pkg", PKGS)
def test_journal_segment_header_carries_round(pkg, tmp_path):
    j = journal_of(pkg, tmp_path, segment_bytes=4096, round_=5)
    j.append({"k": "u", "m": "x", "a": ["z" * 5000]}, 9)
    j.commit()                      # rotates: the new header has round 9
    j.append({"k": "u", "m": "x", "a": [1]}, 9)
    j.commit()
    j.close()
    heads = [JOURNALS[pkg].read_segment(p)[0][0]
             for p in JOURNALS[pkg].scan_segments(str(tmp_path))]
    assert [(h["k"], h["seq"], h["start"], h["round"], h["v"])
            for h in heads] == [("_seg", 0, 0, 5, 1), ("_seg", 1, 1, 9, 1)]


@pytest.mark.parametrize("segment_bytes", [64 << 20, 4096])
def test_segment_files_byte_equal_across_packages(tmp_path, segment_bytes):
    """The same records, appended and committed the same way, leave
    byte-equal segment files from the JAX Journal and the port's: the
    frame, the CRC (zlib in the port, the native crc32 in JAX), the
    msgpack payloads and the segment headers."""
    rng = np.random.default_rng(3)
    frames = train_frames("classifier", 7)
    recs = []
    for i in range(60):
        recs.append(rng.choice([
            {"k": "u", "m": "train", "a": [rows_wire("classifier", [
                ("A", f"t{i}", float(rng.normal()))])]},
            {"k": "train", "f": [[frames[i % 3], 37 + i]]},
            {"k": "diff", "p": {"protocol_version": 2, "round": i,
                                "diff": {"w": rng.bytes(64)}}},
            {"k": "clear"}]))
    for pkg in PKGS:
        j = journal_of(pkg, tmp_path / pkg, segment_bytes=segment_bytes,
                       round_=2)
        for i, r in enumerate(recs):
            j.append(r, 2 + i // 20)
            if i % 7 == 6:
                j.commit()
        j.commit()
        j.close()
    names = [sorted(os.listdir(tmp_path / pkg)) for pkg in PKGS]
    assert names[0] == names[1]
    segs = [n for n in names[0] if n.endswith(".wal")]
    assert (len(segs) == 1) == (segment_bytes > 4096)
    for n in segs:
        assert (tmp_path / "jax" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_journal_refuses_bad_settings(tmp_path):
    with pytest.raises(ValueError, match="journal_fsync"):
        journal_of("port", tmp_path, fsync="sometimes")
    with pytest.raises(ValueError, match="too small"):
        journal_of("port", tmp_path, segment_bytes=100)


def test_batch_policy_timer_bounds_the_idle_tail(tmp_path, monkeypatch):
    """With fsync=batch a lone record is fsynced by the background timer
    within BATCH_SYNC_INTERVAL_S, not only by later traffic."""
    synced = []
    real = tjournal.fsync_file
    monkeypatch.setattr(tjournal, "fsync_file",
                        lambda fp, **kw: (synced.append(1), real(fp, **kw)))
    j = journal_of("port", tmp_path, fsync="batch")
    n0 = len(synced)
    j.append({"k": "clear"})
    j.commit()                          # under the batch threshold
    wait_until(lambda: len(synced) > n0, "the timer's fsync")
    j.close()


def test_truncate_through_spares_the_active_segment_and_the_floor(
        tmp_path):
    j = journal_of("port", tmp_path, segment_bytes=4096)
    for i in range(40):
        j.append({"k": "u", "m": "x", "a": ["w" * 600, i]})
        j.commit()
    n = len(tjournal.scan_segments(str(tmp_path)))
    j.truncate_floor = 20       # record 20 failed to replay
    j.truncate_through(j.position)
    kept = [pos for info, _ in tjournal.scan_segment_records(str(tmp_path))
            for pos in range(info.start, info.end)]
    assert 0 < min(kept) <= 20
    assert len(tjournal.scan_segments(str(tmp_path))) < n
    j.truncate_floor = None
    j.truncate_through(j.position)
    j.close()
    assert len(tjournal.scan_segments(str(tmp_path))) == 1   # the active


# ---------------------------------------------------------------------------
# recovery in the port
# ---------------------------------------------------------------------------


class Wire:
    """One client connection sending pre-encoded frames, reading acks."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=WAIT_S)
        self.unp = msgpack.Unpacker(raw=False, strict_map_key=False)

    def send(self, frame):
        self.sock.sendall(frame)
        while True:
            for msg in self.unp:
                return msg
            self.unp.feed(self.sock.recv(1 << 16))

    def call(self, method, *args):
        msg = self.send(msgpack.packb([0, 99, method, ["t", *args]],
                                      use_bin_type=True))
        if msg[2] is not None:
            raise RuntimeError(msg[2])
        return msg[3]

    def close(self):
        self.sock.close()


def serve_port(service, tmp_path, *extra):
    cfg = tmp_path / f"{service}.json"
    cfg.write_text(json.dumps(CONFIGS[service]))
    return serve(["--type", service, "--configpath", str(cfg), "--rpc-port",
                  "0", "--listen_addr", "127.0.0.1", "--name", "t",
                  "--datadir", str(tmp_path), "--device", "cpu",
                  "--journal", str(tmp_path / "dur"), "--journal_fsync",
                  "batch", "--snapshot_interval", "0", *extra])


def twin(service, frames):
    """An uncrashed driver fed the frames one by one through train_raw."""
    from jubatus_tpu_torch.models import create_driver
    drv = create_driver(service, CONFIGS[service], device="cpu")
    for m in frames:
        drv.train_raw(m, native.load().parse_envelope(m, 0)[4])
    return drv


@pytest.mark.parametrize("service", ["classifier", "regression"])
def test_wire_trains_recover_bitwise_against_an_uncrashed_driver(
        service, tmp_path):
    """Trains over the wire through the ingest pipeline, a snapshot, more
    trains; a restart on the same directory restores the snapshot,
    replays the windows after it through train_converted_batch and holds
    the model of a driver fed the same frames one by one, bitwise."""
    frames = train_frames(service, 11, n_frames=8)
    srv, rpc = serve_port(service, tmp_path)
    try:
        w = Wire(srv.args.rpc_port)
        for m in frames[:4]:
            assert w.send(m)[2] is None
        srv.snapshotter.snapshot_now()
        for m in frames[4:]:
            assert w.send(m)[2] is None
        w.close()
        assert srv.journal.position >= 2
    finally:
        rpc.stop()
        srv.stop()
    srv2, rpc2 = serve_port(service, tmp_path)
    try:
        ri = srv2.recovery_info
        assert ri.restored and ri.replayed >= 1 and ri.errors == 0
        want = twin(service, frames)
        assert packed(srv2) == msgpack.packb(want.pack(), use_bin_type=True)
        st = srv2.get_status()[srv2.server_id]
        assert st["recovery_restored"] == "1"
        assert int(st["recovery_replayed"]) == ri.replayed
        assert float(st["recovery_replay_ms"]) >= 0.0
    finally:
        rpc2.stop()
        srv2.stop()


def test_corrupt_newest_snapshot_falls_back(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    srv.snapshotter.snapshot_now()
    train_u("port", srv, "classifier", [("B", "b1", 1.0)])
    newest = srv.snapshotter.snapshot_now()
    train_u("port", srv, "classifier", [("C", "c1", 1.0)])
    expected = packed(srv)
    shut("port", srv)
    path = tmp_path / "dur" / newest["file"]
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    srv2 = make_server("port", "classifier", tmp_path / "dur")
    ri = srv2.recovery_info
    assert ri.fallback == 1 and ri.restored and ri.replayed == 2
    assert packed(srv2) == expected
    shut("port", srv2)


@pytest.mark.parametrize("quantize", [False, True], ids=["v2", "v3"])
def test_diff_replay_is_round_guarded(tmp_path, quantize):
    """An applied scatter replays through the round-id guard: the second
    boot (whose re-anchor snapshot covers round 1) never folds it twice.
    A v3 body decodes through the port's dequantizer."""
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    put_diff_record("port", srv, diff_payload(
        "port", "classifier", [("B", "b1", 2.0)], 1, quantize), 1)
    train_u("port", srv, "classifier", [("C", "c1", 1.0)], round_=1)
    expected = packed(srv)
    shut("port", srv)
    srv2 = make_server("port", "classifier", tmp_path / "dur")
    assert srv2.recovery_info.round == 1 and srv2._recovered_round == 1
    assert packed(srv2) == expected
    shut("port", srv2)
    srv3 = make_server("port", "classifier", tmp_path / "dur")
    assert packed(srv3) == expected
    assert srv3.driver.get_labels() == {"A": 1, "B": 1, "C": 1}
    shut("port", srv3)


def test_clear_is_replayed(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    srv.clear()
    train_u("port", srv, "classifier", [("B", "b1", 1.0)])
    expected = packed(srv)
    shut("port", srv)
    srv2 = make_server("port", "classifier", tmp_path / "dur")
    assert packed(srv2) == expected
    assert srv2.driver.get_labels() == {"B": 1}
    shut("port", srv2)


@pytest.mark.parametrize("pkg", PKGS)
def test_cmix_records_replay_through_the_epoch_guard(tmp_path, pkg):
    """A collective round's cmix record (mix/collective.py) replays in
    either package: the epoch resumes at the largest recovered, a record
    at or below the snapshot's epoch is not applied again, and a driver
    without replicas only counts the epoch."""
    srv = make_server(pkg, "classifier", tmp_path / "dur")
    train_u(pkg, srv, "classifier", [("A", "a1", 1.0)])
    for cr in (1, 2):
        with srv.model_lock.write():
            srv.journal.append({"k": "cmix", "cr": cr})
    srv.journal.commit()
    shut(pkg, srv)
    srv2 = make_server(pkg, "classifier", tmp_path / "dur")
    try:
        ri = srv2.recovery_info
        assert (ri.replayed, ri.errors, ri.collective_round) == (3, 0, 2)
        assert srv2.driver.get_labels() == {"A": 1}
        # the boot's snapshot carries the epoch: a replayed duplicate
        # (cr 2) is guarded, a later one (cr 3) advances it
        assert Manifest.load(str(tmp_path / "dur")).snapshots[0][
            "collective_round"] == 2
        with srv2.model_lock.write():
            srv2.journal.append({"k": "cmix", "cr": 2})
            srv2.journal.append({"k": "cmix", "cr": 3})
        srv2.journal.commit()
    finally:
        shut(pkg, srv2)
    srv3 = make_server(pkg, "classifier", tmp_path / "dur")
    try:
        ri = srv3.recovery_info
        assert (ri.replayed, ri.errors, ri.collective_round) == (2, 0, 3)
        assert srv3.update_count == 1
    finally:
        shut(pkg, srv3)


def test_journal_dir_is_exclusively_locked(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur")
    with pytest.raises(tjournal.JournalError, match="locked by another"):
        make_server("port", "classifier", tmp_path / "dur")
    shut("port", srv)                     # releases the claim
    shut("port", make_server("port", "classifier", tmp_path / "dur"))


@pytest.mark.parametrize("record, message", [
    ({"k": "u", "m": "no_such_method", "a": []}, "no_such_method"),
    ({"k": "drv", "m": "add", "a": ["1", {}]}, "has no such mutation"),
    ({"k": "cmix", "cr": "one"}, "invalid literal"),
], ids=["unknown_method", "drv", "cmix"])
def test_errored_replay_pins_the_floor_and_suspends_snapshots(
        tmp_path, caplog, record, message):
    """A record the port cannot replay (a driver mutation the service's
    driver lacks, here anomaly's add on a classifier, says so; a cmix
    record whose epoch is no integer) counts as an error: the
    truncation floor pins it, no snapshot publishes (one would mark it
    covered), and a full-model overwrite (checkpoint_after_restore)
    lifts both."""
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    with srv.model_lock.write():
        srv.journal.append(record)
    srv.journal.commit()
    shut("port", srv)
    srv2 = make_server("port", "classifier", tmp_path / "dur",
                       snapshot_interval_sec=0.05)
    try:
        ri = srv2.recovery_info
        assert ri.errors == 1 and ri.first_error_position == 1
        assert message in caplog.text
        assert srv2.journal.truncate_floor == 1
        assert srv2.snapshotter._thread is None        # timer suspended
        time.sleep(0.2)
        assert srv2.snapshotter.snapshot_count == 0
        assert not Manifest.load(str(tmp_path / "dur")).snapshots
        assert srv2.driver.get_labels() == {"A": 1}
        srv2.checkpoint_after_restore()
        assert srv2.journal.truncate_floor is None
        assert srv2.snapshotter._thread is not None
        assert Manifest.load(str(tmp_path / "dur")).snapshots
    finally:
        shut("port", srv2)


def test_a_kernel_failure_during_replay_fails_the_boot(tmp_path,
                                                       monkeypatch):
    """No fallback: a kernel that cannot build or launch while a train
    record replays fails the boot, it is not counted and skipped."""
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_raw_record("port", srv, train_frames("classifier", 5))
    shut("port", srv)
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    def broken(self, rb):
        raise KernelError("train_scan_launch: CUDA error 700")

    monkeypatch.setattr(ClassifierDriver, "train_converted_batch", broken)
    with pytest.raises(KernelError, match="CUDA error 700"):
        make_server("port", "classifier", tmp_path / "dur")
    # the failed boot released the directory's lock
    monkeypatch.undo()
    shut("port", make_server("port", "classifier", tmp_path / "dur"))


def test_snapshot_under_the_model_lock_raises(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur")
    with srv.model_lock.write():
        with pytest.raises(LockDisciplineError, match="write lock"):
            srv.snapshotter.snapshot_now()
    with srv.model_lock.read():
        with pytest.raises(LockDisciplineError, match="read lock"):
            srv.snapshotter.snapshot_now()
    srv.snapshotter.snapshot_now()
    shut("port", srv)


def test_snapshots_truncate_covered_segments_and_reap_orphans(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur",
                      journal_segment_bytes=4096)
    for i in range(30):
        train_u("port", srv, "classifier", [("A", f"tok{i}" * 150, 1.0)])
    assert len(tjournal.scan_segments(str(tmp_path / "dur"))) > 2
    orphan = tmp_path / "dur" / "snapshot-00000041.jubatus"
    orphan.write_bytes(b"left by a crash between rename and MANIFEST")
    srv.snapshotter.snapshot_now()
    srv.snapshotter.snapshot_now()
    assert len(tjournal.scan_segments(str(tmp_path / "dur"))) == 1
    assert not orphan.exists()
    shut("port", srv)


def test_timer_snapshots_and_manifest_corruption(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur",
                      snapshot_interval_sec=0.1)
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    wait_until(lambda: srv.snapshotter.snapshot_count > 0, "a timer snapshot")
    train_u("port", srv, "classifier", [("B", "b1", 1.0)])
    labels = srv.driver.get_labels()
    shut("port", srv)
    (tmp_path / "dur" / "MANIFEST").write_text("{not json")
    srv2 = make_server("port", "classifier", tmp_path / "dur")
    # the snapshot is unreachable, the journal is not: every record
    # replays onto a fresh model
    assert not srv2.recovery_info.restored
    assert srv2.driver.get_labels() == labels
    shut("port", srv2)


def test_get_status_surfaces_durability(tmp_path):
    srv = make_server("port", "classifier", tmp_path / "dur")
    train_u("port", srv, "classifier", [("A", "a1", 1.0)])
    srv.snapshotter.snapshot_now()
    st = srv.get_status()[srv.server_id]
    assert st["journal_enabled"] == "1"
    assert st["journal_fsync"] == "always"
    assert st["journal_position"] == "1"
    assert st["journal_stalled"] == ""
    assert st["snapshot_count"] == "1"
    assert int(st["snapshot_last_bytes"]) > 0
    assert float(st["snapshot_last_pack_ms"]) >= 0.0
    assert st["recovery_restored"] == "0"
    assert st["read_batch_window_us"] == "0"
    assert "journal_records_total" in st
    shut("port", srv)
    off = tserver_base.JubatusServer(
        tserver_base.ServerArgs(type="classifier", name="t", device="cpu"),
        config=json.dumps(CONFIGS["classifier"]))
    st = off.get_status()[off.server_id]
    assert st["journal_enabled"] == "0"
    assert "journal_fsync" not in st and "recovery_restored" not in st


# ---------------------------------------------------------------------------
# across packages, both ways
# ---------------------------------------------------------------------------


# the three histories: where the snapshot falls (none, after the applied
# scatter, before it) and how many records replay past it
HISTORIES = {"journal_only": 6, "snapshot": 2, "snapshot_then_diff": 3}


def write_history(pkg, service, dirpath, history):
    """The TestRecoveryGolden route of tests/test_durability.py on a
    server of `pkg`: a decoded train, a clear, another, an applied f32
    scatter of round 1, a fused raw-train window, a decoded train, with
    a snapshot placed per `history`.  Returns the writer's model (its
    pack) at the crash."""
    srv = make_server(pkg, service, dirpath)
    train_u(pkg, srv, service, [("A", "a0", 1.0), ("B", "b0", -1.0)])
    srv.clear()
    train_u(pkg, srv, service, [("A", "a1", 0.5), ("B", "b1", 2.0)])
    if history == "snapshot_then_diff":
        srv.snapshotter.snapshot_now()
    put_diff_record(pkg, srv, diff_payload(
        pkg, service, [("C", "c1", 1.5), ("A", "a1", -0.5)], 1), 1)
    if history == "snapshot":
        srv.snapshotter.snapshot_now()
    train_raw_record(pkg, srv, train_frames(service, 23))
    train_u(pkg, srv, service, [("C", "c2", 1.0)], round_=1)
    out = srv.driver.pack()
    srv.journal.close()                 # the crash: nothing more is written
    return out


@pytest.mark.parametrize("history", sorted(HISTORIES))
@pytest.mark.parametrize("service", ["classifier", "regression"])
@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_a_directory_recovers_in_the_other_package(tmp_path, service,
                                                   writer, reader, history):
    """One package writes the journal directory; the other recovers it
    to the model the writer's own recovery gives (each on its own copy),
    within rtol 1e-5 / atol 1e-6, labels and counts exact.  The writer's
    recovery is its model at the crash, bitwise, except where a scatter
    replays onto a restored snapshot (snapshot_then_diff): a pack holds
    no MIX bases or pending feature-count deltas, so put_diff folds onto
    zero bases there, in both packages alike (ROADMAP Queue 3 item 7)."""
    at_crash = write_history(writer, service, tmp_path / "dur", history)
    shutil.copytree(tmp_path / "dur", tmp_path / "own")
    shutil.copytree(tmp_path / "dur", tmp_path / "other")
    for name in ("own", "other"):
        os.remove(tmp_path / name / "LOCK")
    own = make_server(writer, service, tmp_path / "own")
    other = make_server(reader, service, tmp_path / "other")
    try:
        for srv in (own, other):
            ri = srv.recovery_info
            assert ri.restored == (history != "journal_only")
            assert ri.replayed == HISTORIES[history] and ri.errors == 0
            assert ri.round == 1
        same = msgpack.packb(own.driver.pack(), use_bin_type=True) == \
            msgpack.packb(at_crash, use_bin_type=True)
        assert same == (history != "snapshot_then_diff")
        assert_close_models(service, own.driver.pack(), other.driver.pack())
        if service == "classifier":
            assert own.driver.get_labels() == other.driver.get_labels()
    finally:
        shut(writer, own)
        shut(reader, other)


# ---------------------------------------------------------------------------
# the WAL root, the durable save
# ---------------------------------------------------------------------------


def test_a_root_listing_secondary_slots_is_refused(tmp_path):
    """The name is kept from when the port refused such a root; it now
    boots with the listed slot restored from its own namespace, under
    the host's config, and a catalog listing nothing boots with the
    default slot alone."""
    root = tmp_path / "dur"
    root.mkdir()
    (root / "MODELS.json").write_text(json.dumps(
        {"version": 1, "models": [{"name": "m1", "tenant": "acme"}]}))
    args = tserver_base.ServerArgs(type="classifier", name="t",
                                   device="cpu", journal_dir=str(root))
    srv = tserver_base.JubatusServer(args,
                                     config=json.dumps(CONFIGS["classifier"]))
    srv.init_durability()
    try:
        assert set(srv.list_models()) == {"t", "m1"}
        m1 = srv.slot_for("m1")
        assert m1 is not srv and m1.tenant == "acme"
        assert m1.config_str == srv.config_str
        assert m1.journal is not None and srv.journal is not None
        assert (root / "slots" / "m1" / "LOCK").exists()
    finally:
        srv.stop()
    # a catalog listing nothing boots
    root2 = tmp_path / "dur2"
    root2.mkdir()
    (root2 / "MODELS.json").write_text(json.dumps({"version": 1,
                                                   "models": []}))
    srv = tserver_base.JubatusServer(
        tserver_base.ServerArgs(type="classifier", name="t", device="cpu",
                                journal_dir=str(root2)),
        config=json.dumps(CONFIGS["classifier"]))
    srv.init_durability()
    assert set(srv.list_models()) == {"t"}
    srv.stop()


@pytest.mark.parametrize("legacy", [False, True])
def test_the_root_is_stamped_layout_v2(tmp_path, legacy):
    """A fresh root is stamped v2; a single-model dir (journal files, no
    LAYOUT) is adopted as the default slot's namespace and recovered."""
    root = tmp_path / "dur"
    expected = None
    if legacy:
        j = journal_of("port", root)
        j.append({"k": "u", "m": "train",
                  "a": [rows_wire("classifier", [("A", "a", 1.0)])]})
        j.commit()
        j.close()
    srv = make_server("port", "classifier", root)
    marker = json.loads((root / "LAYOUT").read_text())
    assert marker["layout_version"] == 2
    assert marker.get("migrated_from") == (1 if legacy else None)
    assert (root / "slots").is_dir()
    expected = {"A": 1} if legacy else {}
    assert srv.driver.get_labels() == expected
    shut("port", srv)


def test_save_fsyncs_file_and_dir_under_a_flock(tmp_path, monkeypatch):
    """save() publishes tmp + fsync + rename + directory fsync, with the
    file's flock held (tests/test_durability.py test_save_fsyncs_file_and_dir)."""
    import fcntl
    srv = tserver_base.JubatusServer(
        tserver_base.ServerArgs(type="classifier", name="t", device="cpu",
                                datadir=str(tmp_path)),
        config=json.dumps(CONFIGS["classifier"]))
    tservice.SERVICES["classifier"].methods["train"].fn(
        srv, rows_wire("classifier", [("A", "x", 1.0)]))
    expected = packed(srv)
    synced, locked = [], []
    real_fsync, real_flock = os.fsync, fcntl.flock
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real_fsync(fd))[1])
    monkeypatch.setattr(fcntl, "flock", lambda fp, op: (locked.append(op),
                                                        real_flock(fp, op))[1])
    (path,) = srv.save("m1").values()
    assert len(synced) >= 2 and fcntl.LOCK_EX in locked
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    srv.clear()
    assert srv.load("m1") is True
    assert packed(srv) == expected


# ---------------------------------------------------------------------------
# the gossip round's pulled fold: journaled, SIGKILL, recovered by both
# ---------------------------------------------------------------------------


def gossip_argv(tmp_path, tag, coordinator, name):
    """A port server process (--device cpu) with --journal in a
    random_mixer cluster whose trigger is out of reach (do_mix mixes)."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(CONFIGS["classifier"]))
    return [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
            "classifier", "--configpath", str(cfg), "--rpc-port", "0",
            "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1", "--device",
            "cpu", "--datadir", str(tmp_path), "--journal",
            str(tmp_path / f"dur_{tag}"), "--journal_fsync", "always",
            "--snapshot_interval", "0", "--name", name, "--coordinator",
            coordinator, "--mixer", "random_mixer", "--interval_sec",
            "100000", "--interval_count", "1000000"]


def diff_records(dirpath):
    return [rec for _pos, _rnd, rec in tjournal.iter_records(str(dirpath))
            if rec.get("k") == "diff"]


class OnePeer:
    """Membership that lists one peer (the JAX mixer's gossip target)."""

    def __init__(self, port):
        self.port = port

    def get_all_nodes(self):
        return [("127.0.0.1", self.port)]


def test_gossip_fold_is_journaled_as_the_jax_record(tmp_path):
    """A port server with --journal and random_mixer pulls its peer's
    delta in a gossip round (do_mix) and is SIGKILLed.  Its journal holds
    the pulled fold as a `diff` record whose bytes are the JAX mixer's
    record of the same pull, and the port's recovery of the directory
    and the JAX package's give the same model, the peer's labels in it
    (no round id: the round guard folds it)."""
    from jubatus_tpu.durability import journal as jj
    from jubatus_tpu.mix.push_mixer import PushMixer as JPushMixer
    from tests.test_torch_cluster_mixed import Proc

    def port_of(proc):
        return int(proc.wait_for("jubatus ready", 60).split()[2]
                   .split("=")[1])

    def train_wire(port, seed):
        w = Wire(port)
        for fr in train_frames("classifier", seed, n_frames=2):
            assert w.send(fr)[2] is None
        w.close()

    coord = Proc([sys.executable, "-m",
                  "jubatus_tpu_torch.cluster.coordinator", "--rpc-port", "0",
                  "--listen_addr", "127.0.0.1"])
    procs = [coord]
    try:
        addr = coord.wait_for("jubacoordinator", 60).split()[-1]
        a, b = (Proc(gossip_argv(tmp_path, t, addr, "g")) for t in "ab")
        procs += [a, b]
        pa, pb = port_of(a), port_of(b)
        members = MembershipClient(addr, "classifier", "g")
        wait_until(lambda: set(members.get_all_nodes()) ==
                   {("127.0.0.1", pa), ("127.0.0.1", pb)}, "both listed")
        members.close()
        # a's gossip reads the member list from a cache up to
        # MEMBERS_TTL_S old: let the one it read before b joined expire
        time.sleep(MEMBERS_TTL_S + 0.2)
        train_wire(pa, 61)
        train_wire(pb, 62)
        with tclient("127.0.0.1", pa, timeout=WAIT_S) as c:
            assert c.call_raw("do_mix", "g") is True, "".join(a.tail)
        a.p.send_signal(signal.SIGKILL)
        a.p.wait(timeout=WAIT_S)
        (rec,) = diff_records(tmp_path / "dur_a")
        assert "round" not in rec["p"]
        # the JAX mixer's record of the same pull: a second peer fed the
        # same frames, pulled by a JAX server's PushMixer
        b2 = Proc(gossip_argv(tmp_path, "b2", addr, "g2"))
        procs.append(b2)
        pb2 = port_of(b2)
        train_wire(pb2, 62)
        jsrv = make_server("jax", "classifier", tmp_path / "jax_mixer")
        try:
            assert JPushMixer(jsrv, OnePeer(pb2), interval_sec=1e9,
                              interval_count=10 ** 9)._gossip_round()
        finally:
            shut("jax", jsrv)
        (jrec,) = diff_records(tmp_path / "jax_mixer")
        assert tjournal.pack_record(rec) == jj.pack_record(jrec)
    finally:
        for p in procs:
            p.kill()
    for name in ("port", "jax"):
        shutil.copytree(tmp_path / "dur_a", tmp_path / name)
        os.remove(tmp_path / name / "LOCK")
    port = make_server("port", "classifier", tmp_path / "port")
    jax_ = make_server("jax", "classifier", tmp_path / "jax")
    try:
        for srv in (port, jax_):
            ri = srv.recovery_info
            assert ri.errors == 0 and ri.replayed >= 2
        labels = port.driver.get_labels()
        assert labels == jax_.driver.get_labels()
        assert_close_models("classifier", port.driver.pack(),
                            jax_.driver.pack())
        peer = twin("classifier", train_frames("classifier", 62,
                                               n_frames=2))
        assert set(peer.get_labels()) <= set(labels)
    finally:
        shut("port", port)
        shut("jax", jax_)
