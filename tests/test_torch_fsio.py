"""The port's injectable filesystem layer (jubatus_tpu_torch/durability/
fsio.py) and the journal's fail-stop reaction to disk faults, against
the JAX package's fsio where both parse the same fault specs.

- Fault specs parse to the same entries in both packages; malformed ones
  raise; the JUBATUS_FSFAULTS environment spec is read once.
- A failed fsync stalls the journal for good (a retried fsync would
  "succeed" over dropped pages); clearing the fault does not unstall it.
- ENOSPC on an append is a recoverable stall: the timer's space probe
  resumes appends once the disk has room, and a torn partial frame is
  truncated away.
- On a port server (--device cpu, --journal), a stalled journal rejects
  train (raw and decoded) and set_label with `journal_stalled:` while
  classify and get_labels go on being served, and get_status names the
  reason.

Every wait has its own timeout."""

import errno
import os
import time

import pytest

from jubatus_tpu.durability import fsio as jfsio
from jubatus_tpu_torch.durability import fsio
from jubatus_tpu_torch.durability import journal as tjournal
from jubatus_tpu_torch.utils.metrics import Registry
from tests.test_torch_durability import (Wire, rows_wire, serve_port,
                                         train_frames, wait_until)


@pytest.fixture(autouse=True)
def no_faults():
    fsio.install(None)
    yield
    fsio.reset_for_tests()


SPECS = ["fsync=EIO", "fsync=EIO@3~journal-", "write=ENOSPC x5 %torn",
         "write=ENOSPCx2~journal-;fsync=EIO@2", "replace=EIO~snapshot-",
         "open=EACCES@2x1"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_as_in_the_jax_package(spec):
    def fields(inj):
        return [(f.op, f.err, f.after, f.count, f.match, f.torn)
                for f in inj.faults]
    assert fields(fsio.parse_spec(spec)) == fields(jfsio.parse_spec(spec))


@pytest.mark.parametrize("spec", ["fsink=EIO", "fsync=ENOTANERRNO",
                                  "write=EIO%ripped"])
def test_malformed_specs_raise(spec):
    with pytest.raises(ValueError):
        fsio.parse_spec(spec)
    assert fsio.parse_spec("  ") is None


def test_the_environment_spec_is_read_once(monkeypatch, tmp_path):
    fsio.reset_for_tests()
    monkeypatch.setenv("JUBATUS_FSFAULTS", "fsync=EIO~victim")
    inj = fsio.injector()
    assert inj is not None and inj.faults[0].match == "victim"
    monkeypatch.setenv("JUBATUS_FSFAULTS", "")
    assert fsio.injector() is inj
    with open(tmp_path / "victim", "wb") as fp:
        with pytest.raises(OSError) as e:
            fsio.fsync_file(fp)
    assert e.value.errno == errno.EIO
    fsio.reset_for_tests()
    monkeypatch.setenv("JUBATUS_FSFAULTS", "not a spec")
    assert fsio.injector() is None          # malformed: logged, disabled


def journal(tmp_path, fsync="always"):
    return tjournal.Journal(str(tmp_path), fsync=fsync, registry=Registry())


def test_a_failed_fsync_stalls_the_journal_for_good(tmp_path):
    j = journal(tmp_path)
    j.append({"k": "clear"})
    j.commit()
    fsio.install(fsio.parse_spec("fsync=EIO~journal-"))
    j.append({"k": "clear"})
    with pytest.raises(tjournal.JournalStalledError, match="fsync_eio"):
        j.commit()
    assert j.stall_reason == "fsync_eio"
    with pytest.raises(tjournal.JournalStalledError):
        tjournal.check_writable(j)
    with pytest.raises(tjournal.JournalStalledError):
        j.append({"k": "clear"})
    fsio.install(None)                    # the disk "recovers"
    time.sleep(3 * tjournal.BATCH_SYNC_INTERVAL_S)
    assert j.stall_reason == "fsync_eio"   # never retried, never cleared
    st = j.get_status()
    assert st["journal_stalled"] == "fsync_eio"
    assert st["journal_stall_permanent"] == "1"
    j.close()
    # what was fsynced survived; the record whose fsync failed was never
    # acked (it may or may not be on disk)
    got = [r for _, _, r in tjournal.iter_records(str(tmp_path))]
    assert 1 <= len(got) <= 2


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
def test_enospc_is_a_recoverable_stall(tmp_path, torn):
    j = journal(tmp_path)
    j.append({"k": "u", "m": "x", "a": [0]})
    j.commit()
    good = os.path.getsize(tjournal.scan_segments(str(tmp_path))[0])
    fsio.install(fsio.parse_spec(
        "write=ENOSPCx2~journal-" + (" %torn" if torn else "")))
    with pytest.raises(tjournal.JournalStalledError, match="append_enospc"):
        j.append({"k": "u", "m": "x", "a": [1]})
    assert j.get_status()["journal_stall_permanent"] == "0"
    # the failed append's partial frame is truncated at once
    assert os.path.getsize(tjournal.scan_segments(str(tmp_path))[0]) == good
    # the timer probes: the first probe fails (the second armed hit), a
    # later one finds room and resumes appends
    wait_until(lambda: j.stall_reason is None, "the space probe's unstall")
    assert j.append({"k": "u", "m": "x", "a": [2]}) == 1
    j.commit()
    j.close()
    assert [r["a"][0] for _, _, r in tjournal.iter_records(str(tmp_path))] \
        == [0, 2]


def test_a_stalled_server_rejects_writes_and_serves_reads(tmp_path):
    srv, rpc = serve_port("classifier", tmp_path, "--journal_fsync", "always")
    try:
        w = Wire(srv.args.rpc_port)
        frames = train_frames("classifier", 3, n_frames=3)
        assert w.send(frames[0])[2] is None                   # acked
        fsio.install(fsio.parse_spec("fsync=EIO~journal-"))
        err = w.send(frames[1])[2]          # its commit hits the fault
        assert "journal_stalled" in err
        fsio.install(None)
        assert "journal_stalled" in w.send(frames[2])[2]     # refused
        for method, args in (
                ("train", [rows_wire("classifier", [("Z", "z", 1.0)])]),
                ("set_label", ["Z"]), ("delete_label", ["l0"]),
                ("clear", [])):
            with pytest.raises(RuntimeError, match="journal_stalled"):
                w.call(method, *args)
        # reads go on being served (frame 1's step ran before its commit
        # failed: an error ack is an ambiguous outcome, not a rollback)
        assert sum(w.call("get_labels").values()) in (4, 8)
        assert len(w.call("classify", [rows_wire("classifier", [
            ("A", "t1", 1.0)])[0][1]])) == 1
        st = w.call("get_status")[srv.server_id]
        assert st["journal_stalled"] == "fsync_eio"
        assert st["journal_stall_permanent"] == "1"
        assert int(st["journal_stall_total"]) >= 1
        w.close()
    finally:
        rpc.stop()
        srv.stop()
    # a restart replays what was acked; the refused frame is not there
    srv2, rpc2 = serve_port("classifier", tmp_path)
    try:
        assert srv2.recovery_info.errors == 0
        got = sum(srv2.driver.get_labels().values())
        assert 4 <= got <= 8          # frame 0, and frame 1 if it landed
    finally:
        rpc2.stop()
        srv2.stop()


def test_the_cli_defaults_are_the_jax_servers():
    """--journal_fsync batch, 64 MiB segments, 60 s snapshots, no lane."""
    from jubatus_tpu.cli.server import make_argparser as jparser
    from jubatus_tpu_torch.cli.server import _parser
    argv = ["--type", "classifier", "--journal", "D"]
    keys = ("journal", "journal_fsync", "journal_segment_bytes",
            "snapshot_interval", "read_batch_window_us")
    ns, jns = _parser().parse_args(argv), jparser().parse_args(argv)
    assert [getattr(ns, k) for k in keys] == [getattr(jns, k) for k in keys]
