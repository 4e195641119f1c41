"""Write-ahead update journal — append-only, CRC-framed, msgpack records
(the port's copy of jubatus_tpu/durability/journal.py; a segment holds
the same bytes in both packages for the same records).

One record = one applied update unit: a fused ingest window (journaled
ONCE per fused device step, not per wire request), a generic update
RPC, an applied MIX scatter (put_diff), or a clear.  Appends happen
under the model write lock so a snapshot packed under the read lock
observes a journal position exactly consistent with the packed state;
the fsync (per policy) happens in commit() AFTER the lock is released so
readers never stall on storage.

Frame layout (all integers big-endian, matching save_load.py):

  u32 payload length | u32 crc32(payload) | payload (msgpack)

Segment files `journal-<seq:08d>.wal` rotate at --journal_segment_bytes;
the first record of every segment is a header record
{"k": "_seg", "seq", "start", "round", "v"} carrying the segment's
starting global record position and the MIX round current at creation,
so replay composes with the round-id machinery and never needs a
separate index file.

fsync policy (RPO = what a host crash can lose; a plain kill -9 loses
only what sits in user-space buffers, which commit() always flushes):

  always   fsync every commit (every acked batch is on stable storage)
  batch    group commit: fsync when >= BATCH_SYNC_RECORDS records or
           BATCH_SYNC_INTERVAL_S elapsed since the last sync
  off      flush to the OS only; the kernel decides when to write

Torn final records (crash mid-append) are expected: the reader stops at
the first invalid frame and reports the valid prefix; recovery truncates
the file there instead of crash-looping.

Disk faults are FAIL-STOP.  A failed fsync is never retried: Linux
clears the fd's error state on report and may have dropped the dirty
pages, so a retried fsync "succeeds" while the acked bytes are gone —
the journal instead goes permanently `stalled`, appends and commits
reject with JournalStalledError, get_status shows the reason, and the
only recovery is a restart that replays the WAL (what fsynced, survived;
what didn't was never acked).  A write ENOSPC is a *recoverable* stall:
the background timer probes the segment for returned space, truncates
the torn tail back to the last good frame boundary, and resumes —
read-only degradation in between.

Left out of the JAX module: the chaos crash points (crash_at=
journal_append) and the obs.health readiness conditions of a stall
(ROADMAP Queue 1 item 7).  Its two locks are named for the lock-order
detector (analysis/lockgraph.py), and every fsync reports itself as a
blocking operation (durability/fsio.py).
"""

from __future__ import annotations

import errno as _errno_mod
import logging
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Tuple
from zlib import crc32

import msgpack

from jubatus_tpu_torch.analysis.lockgraph import MonitoredLock
from jubatus_tpu_torch.durability import fsio
from jubatus_tpu_torch.durability.fsio import fsync_dir, fsync_file
from jubatus_tpu_torch.utils import metrics as _metrics

log = logging.getLogger("jubatus_tpu_torch.durability")

_FRAME = struct.Struct(">II")
FORMAT_VERSION = 1
FSYNC_POLICIES = ("always", "batch", "off")

# group-commit bounds for fsync policy "batch"
BATCH_SYNC_RECORDS = 32
BATCH_SYNC_INTERVAL_S = 0.1


class JournalError(RuntimeError):
    pass


class JournalStalledError(JournalError):
    """The journal has fail-stopped on a disk fault.  Writers must
    error-ack (`journal_stalled:` RPC errors) — the record in hand was
    NOT made durable and must never be reported as such.  Reads keep
    serving; recovery is automatic for ENOSPC (space probe) and a
    restart + WAL replay for a failed fsync."""

    def __init__(self, reason: str):
        super().__init__(f"journal_stalled: {reason}")
        self.reason = reason


# write-path errnos that mean "storage is full, not broken": the stall
# is recoverable by the space probe once the condition clears
_RECOVERABLE_ERRNOS = frozenset(
    e for e in (getattr(_errno_mod, "ENOSPC", None),
                getattr(_errno_mod, "EDQUOT", None)) if e is not None)


def check_writable(journal: Optional["Journal"]) -> None:
    """The write-path admission gate: raise `journal_stalled:` BEFORE
    any model mutation
    when the slot's journal has fail-stopped, so a rejected write leaves
    memory and WAL consistent.  No journal (durability off) or a healthy
    one is one attribute probe."""
    if journal is not None and journal.stall_reason is not None:
        raise JournalStalledError(journal.stall_reason)


def segment_name(seq: int) -> str:
    return f"journal-{seq:08d}.wal"


def lock_dir(dirpath: str):
    """Exclusive per-process claim on a journal directory (flock on
    DIR/LOCK, held for the owner's lifetime).  Two servers pointed at
    one DIR would be silent corruption — recovery truncates what it
    takes for a torn tail, which is the OTHER process's in-flight
    append — so fail fast and typed instead."""
    import fcntl
    os.makedirs(dirpath, exist_ok=True)
    fp = open(os.path.join(dirpath, "LOCK"), "w")
    try:
        fcntl.flock(fp, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        fp.close()
        raise JournalError(
            f"journal directory {dirpath!r} is locked by another server "
            "process — every server needs its OWN --journal DIR")
    return fp


def pack_record(record: Any) -> bytes:
    payload = msgpack.packb(record, use_bin_type=True,
                            unicode_errors="surrogateescape")
    return _FRAME.pack(len(payload), crc32(payload) & 0xFFFFFFFF) + payload


def read_segment(path: str) -> Tuple[List[Any], bool, int]:
    """Read every valid record of a segment file.

    Returns (records, torn, valid_bytes): `records` are the decoded
    payloads in order (including the _seg header record), `torn` is True
    when the file ends in an invalid/partial frame, and `valid_bytes` is
    the offset of the last valid frame end (the truncation point).
    A bad CRC mid-file also stops the scan — framing is length-chained,
    so nothing after an invalid frame can be trusted.
    """
    records: List[Any] = []
    valid = 0
    torn = False
    with open(path, "rb") as fp:
        data = fp.read()
    off, n = 0, len(data)
    while off < n:
        if off + _FRAME.size > n:
            torn = True
            break
        length, crc_expect = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if end > n:
            torn = True
            break
        payload = data[start:end]
        if crc32(payload) & 0xFFFFFFFF != crc_expect:
            torn = True
            break
        try:
            records.append(msgpack.unpackb(
                payload, raw=False, strict_map_key=False,
                unicode_errors="surrogateescape"))
        except Exception:
            torn = True
            break
        off = end
        valid = end
    return records, torn, valid


@dataclass
class SegmentInfo:
    """Metadata recovery hands back to the writer for truncation."""
    seq: int
    path: str
    start: int      # global record position of the first payload record
    end: int        # global record position one past the last record
    round: int = 0  # MIX round from the segment header
    torn: bool = False  # segment ended in an invalid/partial frame


def scan_segments(dirpath: str) -> List[str]:
    """Sorted segment paths present in a journal directory."""
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith("journal-") and n.endswith(".wal"))
    except FileNotFoundError:
        return []
    return [os.path.join(dirpath, n) for n in names]


class Journal:
    """The writer side.  Thread-safe; callers append() under the model
    write lock and commit() after releasing it (see module docstring)."""

    def __init__(self, dirpath: str, *, fsync: str = "batch",
                 segment_bytes: int = 64 << 20, start_position: int = 0,
                 start_seq: int = 0, retained: Optional[List[SegmentInfo]] = None,
                 round_: int = 0, lock_fp=None,
                 registry: Optional["_metrics.Registry"] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"--journal_fsync must be one of "
                             f"{'|'.join(FSYNC_POLICIES)}, got {fsync!r}")
        if segment_bytes < 4096:
            raise ValueError(f"--journal_segment_bytes too small: "
                             f"{segment_bytes} (min 4096)")
        self.dir = dirpath
        self.fsync_policy = fsync
        self.segment_bytes = segment_bytes
        self.position = start_position      # global record index of the NEXT append
        self._seq = start_seq
        # segments holding positions >= truncate_floor are NEVER deleted:
        # recovery sets this to the first record that failed to replay so
        # a restart with the config fixed can still retry it
        self.truncate_floor: Optional[int] = None
        self._closed_segments: List[SegmentInfo] = list(retained or [])
        self._registry = registry if registry is not None else _metrics.GLOBAL
        # fp/position/pending state; appenders take it under the model
        # write lock, so the order is model_lock -> journal -> state (the
        # names are the lock-order detector's, analysis/lockgraph.py)
        self._lock = MonitoredLock("journal.state")
        # serializes sync/rotate/close so the fsync itself can run
        # OUTSIDE _lock: append() (called under the model write lock)
        # must never wait on storage.  Order: _sync_mutex -> _lock.
        self._sync_mutex = MonitoredLock("journal")
        self._fp = None
        self._lock_fp = lock_fp     # dir claim (lock_dir); released in close
        self._seg_start = start_position
        self._pending_sync = 0
        self._last_sync = time.monotonic()
        self._need_rotate = False   # rotation deferred out of append()
        self._rotate_round = 0
        self._closed = False
        # fail-stop state: reason string while stalled (e.g. fsync_eio,
        # append_enospc), None when healthy.  _seg_good_bytes is the
        # byte offset of the last fully-written frame in the active
        # segment — the truncation point a recoverable unstall (or an
        # immediate partial-write cleanup) rewinds the file to.
        self.stall_reason: Optional[str] = None
        self._stall_permanent = False
        self._seg_good_bytes = 0
        self._stop_timer = threading.Event()
        self._timer: Optional[threading.Thread] = None
        os.makedirs(dirpath, exist_ok=True)
        self._open_segment(round_)
        # the timer runs for EVERY fsync policy now: for `batch` it is
        # the deferred group commit (without it, the last <
        # BATCH_SYNC_RECORDS acked batches before an idle period would
        # stay un-fsynced indefinitely — the documented "<= 100 ms" RPO
        # bound must hold without later traffic); for `always`/`off` it
        # only drives the ENOSPC space probe while stalled-recoverable
        self._timer = threading.Thread(target=self._sync_loop,
                                       daemon=True,
                                       name="journal-fsync")
        self._timer.start()

    # -- segment lifecycle (__init__ only; rotation swaps in _do_rotate) -----

    def _open_segment(self, round_: int) -> None:
        path = os.path.join(self.dir, segment_name(self._seq))
        if os.path.exists(path):
            raise JournalError(f"journal segment already exists: {path} "
                               "(recovery must hand the writer a fresh seq)")
        self._fp = fsio.open_append(path)
        self._seg_start = self.position
        header = {"k": "_seg", "v": FORMAT_VERSION, "seq": self._seq,
                  "start": self.position, "round": int(round_)}
        fsio.append_bytes(self._fp, pack_record(header), path=path)
        # the segment file itself must survive a crash before its first
        # commit, or replay would see a gap where records later land
        fsync_file(self._fp, path=path)
        fsync_dir(self.dir)
        self._seg_good_bytes = self._fp.tell()
        self._registry.inc("journal_segments_total")

    # -- writer API ----------------------------------------------------------

    def _enter_stall_locked(self, exc: OSError, during: str,
                            permanent: bool) -> None:
        """Fail-stop transition; caller holds _lock.  First fault wins —
        a permanent stall is never downgraded by a later recoverable
        one.  The partial tail of a failed append is truncated back to
        the last good frame boundary immediately (best effort; the
        space probe retries it) so a kill -9 while stalled leaves a
        clean valid prefix, not injected garbage."""
        if self.stall_reason is not None:
            return
        name = _errno_mod.errorcode.get(exc.errno or 0,
                                        str(exc.errno)).lower()
        self.stall_reason = f"{during}_{name}"
        self._stall_permanent = permanent
        self._registry.inc("journal_stall_total")
        self._registry.set_gauge("journal_stalled", 1.0)
        log.error("journal FAIL-STOP (%s, %s): %s — rejecting writes; "
                  "%s", self.stall_reason,
                  "permanent until restart+replay" if permanent
                  else "probing for recovery", exc,
                  "a failed fsync is never retried (the kernel may have "
                  "dropped the dirty pages)" if during == "fsync"
                  else "tail truncated to the last good frame")
        if not permanent:
            try:
                os.ftruncate(self._fp.fileno(), self._seg_good_bytes)
            except OSError:
                pass

    def append(self, record: dict, round_: int = 0) -> int:
        """Append one record; returns its global position.  Call under
        the model write lock (position/pack consistency with snapshots);
        durability happens in commit().  While stalled (disk fault) the
        append rejects up front — fail-stop, never half-written."""
        frame = pack_record(record)
        with self._lock:
            if self._closed:
                raise JournalError("journal is closed")
            if self.stall_reason is not None:
                raise JournalStalledError(self.stall_reason)
            try:
                fsio.append_bytes(self._fp, frame)
            except OSError as e:
                self._enter_stall_locked(
                    e, "append",
                    permanent=e.errno not in _RECOVERABLE_ERRNOS)
                raise JournalStalledError(self.stall_reason) from e
            self._seg_good_bytes = self._fp.tell()
            pos = self.position
            self.position += 1
            self._pending_sync += 1
            self._registry.inc("journal_records_total")
            self._registry.inc("journal_bytes_total", len(frame))
            self._registry.set_gauge("journal_position", self.position)
            if self._fp.tell() >= self.segment_bytes:
                # rotation fsyncs the old segment + the directory —
                # storage work that must NOT run here (the caller holds
                # the model write lock); commit() picks it up after the
                # lock is released.  segment_bytes is a soft threshold.
                self._need_rotate = True
                self._rotate_round = round_
        return pos

    def commit(self) -> None:
        """Make appended records durable per the fsync policy.  Call
        AFTER releasing the model lock, before acking the client.

        The fsync runs outside _lock (only _sync_mutex held): a
        concurrent append() — which executes under the MODEL write lock
        — must never block on storage, or every read RPC would stall
        behind the disk.  _sync_mutex keeps the fp alive across the
        unlocked fsync (rotation and close also take it)."""
        with self._sync_mutex:
            with self._lock:
                if self.stall_reason is not None:
                    raise JournalStalledError(self.stall_reason)
            try:
                self._sync_once(force=False)
            except OSError as e:
                # ANY sync-path failure is a permanent fail-stop: the
                # fsync (or rotation fsync) may already have poisoned
                # the fd, and retrying a failed fsync silently loses
                # the dropped dirty range (fsyncgate)
                with self._lock:
                    self._enter_stall_locked(e, "fsync", permanent=True)
                raise JournalStalledError(self.stall_reason) from e

    def _sync_once(self, force: bool) -> bool:
        """One group-commit pass; caller holds _sync_mutex.  `force`
        skips the batch-policy thresholds (the timer's job is to bound
        the idle tail regardless of record count).  Returns False once
        the journal is closed."""
        with self._lock:
            if self._closed:
                return False
            need_rotate = self._need_rotate
            self._need_rotate = False
            if not need_rotate:
                if self._pending_sync == 0:
                    return True
                self._fp.flush()    # kill -9 safety: out of user-space
                #                     buffers
                if self.fsync_policy == "off":
                    self._pending_sync = 0
                    return True
                if self.fsync_policy == "batch" and not force:
                    now = time.monotonic()
                    if (self._pending_sync < BATCH_SYNC_RECORDS
                            and now - self._last_sync
                            < BATCH_SYNC_INTERVAL_S):
                        return True
            fp = self._fp
            synced = self._pending_sync
        if need_rotate:
            # rare (once per segment_bytes); rotation swaps self._fp
            # so it re-acquires _lock internally around the swap
            self._do_rotate(self._rotate_round)
        else:
            fsync_file(fp)
            self._registry.inc("journal_fsync_total")
        with self._lock:
            # only clear what this sync covered — records appended
            # during the unlocked fsync keep their pending count
            self._pending_sync = max(0, self._pending_sync - synced)
            self._last_sync = time.monotonic()
        return True

    def _do_rotate(self, round_: int) -> None:
        """Rotation under _sync_mutex: every real storage wait — the old
        segment's catch-up fsync AND the new file's create/fsync/dir-fsync
        — runs OUTSIDE _lock (appends continue into the old segment
        harmlessly; the swap below re-checks), so an append() racing this
        rotation under the model write lock only ever blocks on the cheap
        swap itself."""
        with self._lock:
            old = self._fp
            new_seq = self._seq + 1
        fsync_file(old)
        path = os.path.join(self.dir, segment_name(new_seq))
        if os.path.exists(path):
            raise JournalError(f"journal segment already exists: {path} "
                               "(recovery must hand the writer a fresh seq)")
        new_fp = fsio.open_append(path)
        fsync_file(new_fp, path=path)
        fsync_dir(self.dir)        # the dir ENTRY must be durable before
        #                            any record in the file is acked
        with self._lock:
            # everything written so far (including appends that landed
            # during the fsyncs) is in the old segment; anything after
            # this block goes to the new one.  A final flush+fsync under
            # _lock covers that small window — the old file is hot in
            # the disk cache, so this second fsync is cheap.
            fsync_file(old)
            old.close()
            self._closed_segments.append(SegmentInfo(
                seq=self._seq,
                path=os.path.join(self.dir, segment_name(self._seq)),
                start=self._seg_start, end=self.position))
            self._seq = new_seq
            self._fp = new_fp
            self._seg_start = self.position
            # buffered write only — the header's durability rides the
            # next commit(); until then the segment holds no acked
            # record, so losing it to a crash leaves no gap
            header = {"k": "_seg", "v": FORMAT_VERSION, "seq": new_seq,
                      "start": self.position, "round": int(round_)}
            fsio.append_bytes(self._fp, pack_record(header), path=path)
            self._seg_good_bytes = self._fp.tell()
        self._registry.inc("journal_segments_total")
        self._registry.inc("journal_rotations_total")

    def _sync_loop(self) -> None:
        """Background journal keeper, every fsync policy.

        Healthy + policy `batch`: the deferred group commit bounding the
        un-synced tail to BATCH_SYNC_INTERVAL_S even when traffic goes
        idle right after the last ack.  A storage failure here must
        fail-stop the journal, NOT kill this thread silently, or every
        later batch-policy ack would ride an fsync that never ran.

        Stalled-recoverable (ENOSPC): drives the space probe until the
        disk has room again, then resumes appends."""
        while not self._stop_timer.wait(BATCH_SYNC_INTERVAL_S):
            with self._sync_mutex:
                with self._lock:
                    if self._closed:
                        return
                    stalled = self.stall_reason is not None
                    permanent = self._stall_permanent
                if stalled:
                    if not permanent:
                        self._try_unstall()
                    continue
                if self.fsync_policy != "batch":
                    continue
                try:
                    if not self._sync_once(force=True):
                        return
                except OSError as e:
                    with self._lock:
                        self._enter_stall_locked(e, "fsync", permanent=True)

    def _try_unstall(self) -> bool:
        """ENOSPC recovery pass; caller holds _sync_mutex.  Rewind the
        active segment to the last good frame boundary, then PROBE for
        space with a throwaway write (through fsio, so injected faults
        govern it) that is truncated away again — the journal never
        fabricates a record.  Only a successful probe clears the stall.  A crash between probe write and truncate leaves a
        zero-bytes tail the torn-tail reader already discards."""
        with self._lock:
            if (self.stall_reason is None or self._stall_permanent
                    or self._closed):
                return self.stall_reason is None
            fp = self._fp
            good = self._seg_good_bytes
        # probe outside _lock: appends reject while stalled and rotation
        # needs _sync_mutex (held), so fp cannot change under us
        try:
            os.ftruncate(fp.fileno(), good)
            fsio.append_bytes(fp, b"\0" * 8)
            os.ftruncate(fp.fileno(), good)
        except OSError:
            try:
                os.ftruncate(fp.fileno(), good)
            except OSError:
                pass
            return False
        with self._lock:
            reason, self.stall_reason = self.stall_reason, None
            self._stall_permanent = False
            self._registry.inc("journal_unstall_total")
            self._registry.set_gauge("journal_stalled", 0.0)
        log.warning("journal: stall %r cleared (space recovered at %d "
                    "good bytes); resuming appends", reason, good)
        return True

    def truncate_through(self, covered_position: int) -> int:
        """Delete closed segments entirely covered by a snapshot (every
        record index < covered_position).  The active segment is never
        deleted, nor is anything at/past truncate_floor (un-replayable
        records an operator may still want to retry).  Returns the
        number of segments removed."""
        removed = 0
        with self._lock:
            if self.truncate_floor is not None:
                covered_position = min(covered_position, self.truncate_floor)
            keep: List[SegmentInfo] = []
            for seg in self._closed_segments:
                if seg.end <= covered_position:
                    try:
                        os.remove(seg.path)
                        removed += 1
                    except FileNotFoundError:
                        removed += 1
                    except OSError:
                        log.warning("could not remove covered journal "
                                    "segment %s", seg.path, exc_info=True)
                        keep.append(seg)
                else:
                    keep.append(seg)
            self._closed_segments = keep
        if removed:
            self._registry.inc("journal_truncated_segments_total", removed)
        return removed

    def close(self) -> None:
        self._stop_timer.set()
        with self._sync_mutex:      # never close the fp under an
            with self._lock:        # in-flight unlocked fsync
                if self._closed:
                    return
                self._closed = True
                try:
                    # a stalled journal is NEVER fsynced on close: for a
                    # permanent stall that would retry the poisoned fd
                    # (fsyncgate); for ENOSPC the tail is already
                    # truncated to the last good frame
                    if self.stall_reason is None:
                        fsync_file(self._fp)
                finally:
                    self._fp.close()
                    if self._lock_fp is not None:
                        self._lock_fp.close()   # releases the dir flock
        if self._timer is not None:
            self._timer.join(timeout=5)

    def get_status(self) -> dict:
        with self._lock:
            return {
                "journal_fsync": self.fsync_policy,
                "journal_position": str(self.position),
                "journal_segment_seq": str(self._seq),
                "journal_segment_bytes": str(self.segment_bytes),
                "journal_retained_segments": str(len(self._closed_segments) + 1),
                "journal_stalled": self.stall_reason or "",
                "journal_stall_permanent": str(int(
                    self.stall_reason is not None and self._stall_permanent)),
            }


def scan_segment_records(dirpath: str, *, truncate_torn: bool = False,
                         registry: Optional["_metrics.Registry"] = None,
                         ) -> Iterator[Tuple[SegmentInfo, List[Any]]]:
    """THE shared read-side scan: yields (SegmentInfo, payload_records)
    per segment in order, in one disk pass.  recover() and iter_records
    consume this — torn-tail handling and
    header/position derivation live in exactly one place.

    A torn tail stops the scan of that segment; with truncate_torn the
    file is truncated at the last valid frame so later boots never
    re-parse the garbage.  Torn tails are COUNTED (recovery metrics +
    SegmentInfo.torn) but never raised — a crash-loop on a torn record
    would defeat the whole recovery story.  A missing/garbled header
    makes the segment contribute no records (positions underivable) but
    still yields an empty SegmentInfo so truncation can clean it up.
    """
    reg = registry if registry is not None else _metrics.GLOBAL
    for path in scan_segments(dirpath):
        try:
            seq = int(os.path.basename(path)[len("journal-"):-len(".wal")])
        except ValueError:
            continue
        records, torn, valid = read_segment(path)
        if torn:
            reg.inc("recovery_torn_tail_total")
            log.warning("journal segment %s has a torn tail; keeping the "
                        "%d-byte valid prefix (%d records)", path, valid,
                        len(records))
            if truncate_torn:
                try:
                    with open(path, "r+b") as fp:
                        fp.truncate(valid)
                except OSError:
                    log.warning("could not truncate torn segment %s", path,
                                exc_info=True)
        if not (records and isinstance(records[0], dict)
                and records[0].get("k") == "_seg"):
            if records:
                log.error("journal segment %s lacks a header record; "
                          "skipping %d records (cannot derive positions)",
                          path, len(records))
            yield SegmentInfo(seq=seq, path=path, start=0, end=0,
                              torn=torn), []
            continue
        head = records[0]
        start = int(head.get("start", 0))
        yield SegmentInfo(seq=seq, path=path, start=start,
                          end=start + len(records) - 1,
                          round=int(head.get("round", 0)), torn=torn), \
            records[1:]


def iter_records(dirpath: str, *, truncate_torn: bool = False,
                 registry: Optional["_metrics.Registry"] = None,
                 ) -> Iterator[Tuple[int, int, Any]]:
    """Flat record view over scan_segment_records: yields
    (global_position, segment_round, record) for payload records."""
    for info, records in scan_segment_records(dirpath,
                                              truncate_torn=truncate_torn,
                                              registry=registry):
        for offset, rec in enumerate(records):
            yield info.start + offset, info.round, rec

