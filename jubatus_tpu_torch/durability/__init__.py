"""Durability plane of the port — write-ahead journal, background
snapshots, crash recovery (counterpart of jubatus_tpu/durability/).

  fsio.py         the injectable filesystem layer every fsync, journal
                  append and durable rename runs through
  journal.py      append-only, CRC-framed, msgpack record log of applied
                  updates; one record per fused ingest window, update RPC,
                  applied put_diff or clear; segment rotation, fsync
                  policy always|batch|off; fail-stop stalls on disk faults
  snapshotter.py  timer thread packing the driver under the READ lock,
                  tmp+fsync+rename snapshot writes, MANIFEST upkeep,
                  covered-segment truncation
  recovery.py     boot pipeline: newest valid snapshot (CRC fallback to
                  the previous), journal replay past the covered position
                  through the card's kernels, tolerating a torn final
                  record, mix-round restoration

Disk layout under --journal DIR (the JAX package's, so either package
recovers a directory the other wrote; tenancy/layout.py stamps LAYOUT):

  LAYOUT                      JSON {"layout_version": 2}
  MANIFEST                    JSON: retained snapshots (newest first,
                              each with covered journal position + mix
                              round) — atomically replaced
  journal-<seq>.wal           CRC-framed record segments
  snapshot-<id>.jubatus       save_model-format snapshots (same bytes
                              an operator `save` produces)
  LOCK                        the owning process's flock

`write_file_durably` is the shared atomic publish (snapshots, MANIFEST,
LAYOUT, the operator's `save`).  Left out of the JAX package: the chaos
crash points around the publish's rename.
"""

from __future__ import annotations

import logging
import os
import time
from typing import BinaryIO, Callable, Tuple

from jubatus_tpu_torch.durability import fsio
from jubatus_tpu_torch.durability.fsio import fsync_dir, fsync_file

log = logging.getLogger("jubatus_tpu_torch.durability")


def write_file_durably(path: str, writer: Callable[[BinaryIO], None]
                       ) -> Tuple[float, float]:
    """tmp + fsync + rename + dir-fsync atomic file publish.  `writer(fp)`
    produces the content.  Returns (write_s, sync_s): the writer's time,
    and the time of the fsync, rename and directory fsync."""
    tmp = path + ".tmp"
    t0 = time.perf_counter()
    with open(tmp, "wb") as fp:
        writer(fp)
        fp.flush()
        t1 = time.perf_counter()
        fsync_file(fp, path=tmp)
    fsio.replace(tmp, path)
    fsync_dir(os.path.dirname(path))
    return t1 - t0, time.perf_counter() - t1


def init_durability(slot):
    """Recover state from `slot.args.journal_dir`, then open the
    write-ahead journal and the background snapshotter on the slot.

    Returns the RecoveryResult (also stored as slot.recovery_info).
    Must run BEFORE the slot is routable: replay mutates the driver with
    no lock held.
    """
    from jubatus_tpu_torch.durability.journal import Journal, lock_dir
    from jubatus_tpu_torch.durability.recovery import recover
    from jubatus_tpu_torch.durability.snapshotter import Snapshotter

    dirpath = slot.args.journal_dir
    os.makedirs(dirpath, exist_ok=True)
    # exclusive claim BEFORE recovery: recovery truncates torn tails,
    # and another live owner's in-flight append looks exactly like one
    lock_fp = lock_dir(dirpath)
    try:
        result = recover(slot, dirpath)
        slot._recovered_round = result.round
        slot.recovery_info = result
        slot.journal = Journal(
            dirpath, fsync=slot.args.journal_fsync,
            segment_bytes=slot.args.journal_segment_bytes,
            start_position=result.position, start_seq=result.next_seq,
            retained=result.segments, round_=result.round,
            lock_fp=lock_fp)
        # errored records stay on disk for a retry after the config is
        # fixed: neither this boot's snapshots nor the timer's may
        # truncate their segments
        slot.journal.truncate_floor = result.first_error_position
    except BaseException:
        lock_fp.close()
        raise
    slot.snapshotter = Snapshotter(
        slot, slot.journal, dirpath,
        interval_sec=slot.args.snapshot_interval_sec)
    if result.replayed and not result.errors:
        # re-anchor: fold the replayed tail into a fresh snapshot so the
        # NEXT crash does not replay it again from ever-older segments.
        # Not after errors: the snapshot would mark the errored records
        # covered and truncation would destroy them
        try:
            slot.snapshotter.snapshot_now()
        except Exception:
            log.warning("post-recovery snapshot failed; journal replay "
                        "will repeat on next boot", exc_info=True)
    if result.errors:
        # the timer stays OFF too: a published snapshot would record a
        # covered position past the errored records, and the next boot
        # would skip them.  checkpoint_after_restore resumes snapshots
        # once a full-model overwrite (operator load, straggler
        # catch-up) supersedes them
        log.error("recovery replayed with %d errors; skipping the "
                  "re-anchor snapshot, suspending background snapshots, "
                  "and pinning journal truncation below position %s so "
                  "the errored records survive for a retry after the "
                  "config is fixed", result.errors,
                  result.first_error_position)
    else:
        slot.snapshotter.start()
    if result.restored or result.replayed:
        log.info("durability: recovered from %s (%d records replayed, "
                 "%d torn, %d snapshot fallbacks, mix round %d)",
                 result.source or "journal", result.replayed, result.torn,
                 result.fallback, result.round)
    return result


__all__ = ["fsync_dir", "fsync_file", "init_durability",
           "write_file_durably"]
