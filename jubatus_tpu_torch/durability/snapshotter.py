"""Background snapshotter — periodic durable model images + MANIFEST
(the port's copy of jubatus_tpu/durability/snapshotter.py).

A snapshot first flushes the ingest pipeline (every acked train is in
the image), then packs the driver under the model READ lock (never the
write lock: packing is a pure copy), capturing the journal position and
MIX round in the same critical section.  The pack's copies to the host
synchronize the card's default stream, which every kernel of the port
runs on, so the image holds every step journaled before that position.
It then publishes the snapshot via tmp+fsync+rename+dir-fsync and
updates the MANIFEST.

MANIFEST (JSON, atomically replaced; the JAX package reads it too):

  {"version": 1,
   "snapshots": [{"file": "snapshot-00000007.jubatus",
                  "covered_position": 1234, "round": 9,
                  "collective_round": 2, "local_id": 3, "time": ...},
                 ...newest first, KEEP entries...]}

Journal segments whose every record is covered by the OLDEST retained
snapshot are deleted — keeping two snapshots means a CRC-corrupt newest
image falls back to the previous one with its replay window intact.

Snapshot files use the exact save_model format an operator `save`
produces.  Each snapshot's pack (read-lock wait and copy to the host),
write and fsync times are kept for get_status
(snapshot_last_{pack,write,sync}_ms).  Left out of the JAX
module: the crash points around the publish, and the single-device-thread
routing of inline dispatch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from jubatus_tpu_torch.analysis.lockgraph import MonitoredLock
from jubatus_tpu_torch.durability import fsync_dir, write_file_durably
from jubatus_tpu_torch.utils import metrics as _metrics
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError

log = logging.getLogger("jubatus_tpu_torch.durability")

MANIFEST_NAME = "MANIFEST"
MANIFEST_VERSION = 1
KEEP_SNAPSHOTS = 2


def snapshot_name(snap_id: int) -> str:
    return f"snapshot-{snap_id:08d}.jubatus"


def _snapshot_id(name: str) -> Optional[int]:
    try:
        return int(name[len("snapshot-"):-len(".jubatus")])
    except ValueError:
        return None


class Manifest:
    """Load/store of the durability MANIFEST; entries newest first."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self.path = os.path.join(dirpath, MANIFEST_NAME)
        self.snapshots: List[Dict] = []

    @classmethod
    def load(cls, dirpath: str) -> "Manifest":
        m = cls(dirpath)
        try:
            with open(m.path, "r") as fp:
                obj = json.load(fp)
            if obj.get("version") != MANIFEST_VERSION:
                log.error("MANIFEST version %r unsupported; ignoring it",
                          obj.get("version"))
            else:
                m.snapshots = list(obj.get("snapshots", []))
        except FileNotFoundError:
            pass
        except (OSError, ValueError):
            # a torn MANIFEST must not block recovery: the journal is the
            # source of truth and a full replay is always safe
            log.warning("unreadable MANIFEST %s; recovering from the "
                        "journal alone", m.path, exc_info=True)
        return m

    def store(self) -> None:
        payload = json.dumps({"version": MANIFEST_VERSION,
                              "snapshots": self.snapshots},
                             indent=1).encode()
        write_file_durably(self.path, lambda fp: fp.write(payload))

    def covered_floor(self) -> int:
        """Journal position below which every retained snapshot's replay
        window begins — the truncation bound."""
        if not self.snapshots:
            return 0
        return min(int(s.get("covered_position", 0)) for s in self.snapshots)


class Snapshotter:
    def __init__(self, slot, journal, dirpath: str,
                 interval_sec: float = 0.0, keep: int = KEEP_SNAPSHOTS,
                 registry: Optional["_metrics.Registry"] = None):
        self.slot = slot
        self.journal = journal
        self.dirpath = dirpath
        self.interval_sec = interval_sec
        self.keep = max(1, keep)
        self._registry = registry if registry is not None else _metrics.GLOBAL
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snap_lock = MonitoredLock("snapshot")  # one publish at a time
        self.snapshot_count = 0
        self.last_snapshot_id = -1
        self.last_snapshot_time = 0.0
        self.last_snapshot_bytes = 0
        # the newest snapshot's pack, write and fsync seconds
        self.last_times = (0.0, 0.0, 0.0)
        self._next_id = self._scan_next_id(Manifest.load(dirpath))

    def _scan_next_id(self, manifest: Manifest) -> int:
        """One past every id in the MANIFEST and on disk: an orphaned
        snapshot file (a crash between rename and MANIFEST update) must
        not collide with the next id either."""
        names = [ent.get("file", "") for ent in manifest.snapshots]
        try:
            names += [n for n in os.listdir(self.dirpath)
                      if n.startswith("snapshot-") and n.endswith(".jubatus")]
        except FileNotFoundError:
            pass
        ids = [i for i in map(_snapshot_id, names) if i is not None]
        return max(ids, default=-1) + 1

    # -- timer thread --------------------------------------------------------

    def start(self) -> None:
        if self.interval_sec <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="snapshotter")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_sec):
            try:
                self.snapshot_now()
            except Exception:
                # a failing disk must not kill the timer: the journal
                # keeps growing and the operator sees snapshot_age climb
                log.exception("background snapshot failed")

    # -- the snapshot itself -------------------------------------------------

    def snapshot_now(self) -> Dict:
        """Take one snapshot synchronously; returns the MANIFEST entry.

        Calling this while holding the model lock (either side) would
        deadlock the pipeline flush or the read acquire, so it fails
        typed instead."""
        slot = self.slot
        lock = slot.model_lock
        if lock.write_held_by_me():
            raise LockDisciplineError(
                "snapshot_now() while holding the model write lock: the "
                "pack needs the READ lock — release first (durability/"
                "snapshotter.py)")
        if lock.read_held_by_me():
            raise LockDisciplineError(
                "snapshot_now() while holding the model read lock: "
                "re-entrant read acquires deadlock under writer "
                "preference — release first (durability/snapshotter.py)")
        t0 = time.perf_counter()
        # order acked fused trains into the image (flush BEFORE any model
        # lock — the framework/dispatch.py rule)
        if slot.dispatcher is not None:
            slot.dispatcher.flush()
        t1 = time.perf_counter()
        with slot.model_lock.read():
            data = slot.driver.pack()
            position = self.journal.position
            round_ = slot.current_mix_round()
            # the collective epoch travels with the image, so recovery's
            # cmix guard resumes from it after the journal is truncated
            cround = slot.current_collective_round()
            # the standalone id sequence's watermark: ids minted after this
            # read have their records past `position`, so recovery's max of
            # the entry and the replayed ids covers them
            local_id = slot._local_id
        pack_s = time.perf_counter() - t1
        with self._snap_lock:
            entry, covered_floor = self._publish(data, position, round_,
                                                 cround, local_id, t0,
                                                 pack_s)
        # journal truncation AFTER releasing _snap_lock (lock order
        # journal -> snapshot); a racing publish truncates with its own,
        # possibly smaller, floor and so only removes fewer segments
        self.journal.truncate_through(covered_floor)
        return entry

    def _publish(self, data, position: int, round_: int, cround: int,
                 local_id: int, t0: float, pack_s: float):
        """Disk side of one snapshot (under _snap_lock).  Returns
        (manifest_entry, covered_floor)."""
        from jubatus_tpu_torch.framework.save_load import save_model
        from jubatus_tpu_torch.framework.server_base import USER_DATA_VERSION
        slot = self.slot
        snap_id = self._next_id
        self._next_id += 1
        fname = snapshot_name(snap_id)
        path = os.path.join(self.dirpath, fname)

        def writer(fp):
            save_model(fp, server_type=slot.args.type,
                       model_id=f"snapshot-{snap_id}",
                       config=slot.config_str,
                       user_data_version=USER_DATA_VERSION,
                       driver_data=data)

        write_s, sync_s = write_file_durably(path, writer)
        size = os.path.getsize(path)

        manifest = Manifest.load(self.dirpath)
        entry = {"file": fname, "covered_position": position,
                 "round": round_, "collective_round": cround,
                 "local_id": local_id, "time": time.time()}
        # by coverage, not insertion: concurrent snapshot_nows may publish
        # out of pack order (the stable sort keeps the newer file first)
        entries = [entry] + manifest.snapshots
        entries.sort(key=lambda e: int(e.get("covered_position", 0)),
                     reverse=True)
        manifest.snapshots = entries[:self.keep]
        manifest.store()
        # delete EVERY snapshot file the MANIFEST no longer references,
        # orphans of a crash between rename and MANIFEST store included
        referenced = {e.get("file") for e in manifest.snapshots}
        removed_any = False
        for name in os.listdir(self.dirpath):
            if (name.startswith("snapshot-") and name.endswith(".jubatus")
                    and name not in referenced):
                try:
                    os.remove(os.path.join(self.dirpath, name))
                    removed_any = True
                except OSError:
                    pass
        if removed_any:
            fsync_dir(self.dirpath)

        dt = time.perf_counter() - t0
        self.snapshot_count += 1
        self.last_snapshot_id = snap_id
        self.last_snapshot_time = time.time()
        self.last_snapshot_bytes = size
        self.last_times = (pack_s, write_s, sync_s)
        reg = self._registry
        reg.inc("snapshot_total")
        reg.observe("snapshot_write", dt)
        reg.set_gauge("snapshot_last_id", snap_id)
        reg.set_gauge("snapshot_covered_position", position)
        log.info("snapshot %d: %d bytes, covers journal position %d "
                 "(round %d), %.3fs (pack %.3f, write %.3f, fsync %.3f)",
                 snap_id, size, position, round_, dt, pack_s, write_s,
                 sync_s)
        # the truncation bound: the OLDEST retained snapshot keeps its
        # whole replay window on disk
        return entry, manifest.covered_floor()

    def get_status(self) -> Dict[str, str]:
        age = (time.time() - self.last_snapshot_time
               if self.last_snapshot_time else -1.0)
        pack_s, write_s, sync_s = self.last_times
        return {
            "snapshot_interval_sec": str(self.interval_sec),
            "snapshot_count": str(self.snapshot_count),
            "snapshot_last_id": str(self.last_snapshot_id),
            "snapshot_age_sec": f"{age:.1f}",
            "snapshot_last_bytes": str(self.last_snapshot_bytes),
            "snapshot_last_pack_ms": f"{pack_s * 1e3:.3f}",
            "snapshot_last_write_ms": f"{write_s * 1e3:.3f}",
            "snapshot_last_sync_ms": f"{sync_s * 1e3:.3f}",
        }
