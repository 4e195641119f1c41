"""Crash recovery — snapshot restore + journal replay + round adoption
(the port's copy of jubatus_tpu/durability/recovery.py).

Boot pipeline (run BEFORE the server is routable; the driver is mutated
with no lock held, single-threaded):

  1. Load the newest valid snapshot named by the MANIFEST; a
     CRC-invalid / truncated / unreadable image falls back to the
     previous retained one (counted as recovery_fallback_total).
  2. Replay journal records past the restored snapshot's covered
     position.  A torn final record truncates at the last valid frame
     and keeps going — recovery must never crash-loop on the very
     failure it exists to absorb.
  3. Restore the MIX round: the snapshot's round, advanced by any
     replayed put_diff records (each guarded by the same round <=
     current idempotency check the live path uses, so no scatter is
     ever folded twice).

Afterwards the server joins its cluster as usual; rounds it slept
through heal through the ordinary straggler path
(LinearMixer.catch_up_if_behind).

Record kinds replayed (append sites: framework/service.py,
framework/dispatch.py, framework/server_base.py, mix/linear_mixer.py,
mix/push_mixer.py):

  train  one fused ingest window: [[msg_bytes, params_off], ...] —
         re-converted by the driver's C converter and trained as ONE
         train_converted_batch, which launches the scan kernel on the
         card: the replayed step is bitwise the one the live path ran
  u      an update RPC: method name + wire args, applied through the
         same ServiceDef Method fn the live handler used
  diff   an applied MIX scatter or push: the packed payload, decoded by
         codec.decode (dequantize_int8 on the card for a v3 body) and
         replayed through the round-id guard
  clear  model reset

  drv    a driver mutation with no wire method: anomaly's add, whose
         server-generated id the record carries ({"k": "drv", "m":
         "add", "a": [id, datum]})

The id watermark: a standalone server mints ids from a local counter
(server_base idgen), so recovery sets that counter past every id the
restored snapshot (its MANIFEST entry's local_id) and the journal (every
drv or u record of an id-minting method, replayed or covered) hold: a
recovered server never mints an id twice.

A `cmix` record is a collective MIX round of a data-parallel server
(mix/collective.py): replay re-runs the driver's device_mix at the same
point of the replayed stream, through an epoch guard on its `cr` (a
record at or below the snapshot's collective_round is not folded again),
and the epoch resumes at the largest one recovered.  A driver without
replicas only advances the epoch.

No fallback to the CPU: a kernel that fails to build or launch during
replay (kernels.build.KernelError) fails the boot.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.durability.journal import (SegmentInfo,
                                                  scan_segment_records)
from jubatus_tpu_torch.durability.snapshotter import Manifest
from jubatus_tpu_torch.kernels.build import KernelError
from jubatus_tpu_torch.utils import metrics as _metrics

log = logging.getLogger("jubatus_tpu_torch.durability")

def _drv_add(slot, row_id, datum):
    from jubatus_tpu_torch.fv import Datum
    slot.driver.add(row_id.decode() if isinstance(row_id, bytes) else row_id,
                    Datum.from_msgpack(datum))


# driver mutations journaled without a wire method (framework/service.py
# _anomaly_add): name -> apply(slot, *args)
DRIVER_REPLAY = {"add": _drv_add}

# record methods whose first argument is a server-generated id (anomaly's
# add; the JAX package's graph methods too, so a directory of either
# package sets the watermark alike)
_ID_METHODS = {"add", "create_node_here", "create_edge_here",
               "remove_global_node"}


def _record_id_watermark(rec: Any) -> int:
    if not isinstance(rec, dict) or rec.get("k") not in ("drv", "u") \
            or rec.get("m") not in _ID_METHODS:
        return 0
    args = rec.get("a") or []
    if not args:
        return 0
    head = args[0]
    if isinstance(head, bytes):
        head = head.decode("utf-8", "surrogateescape")
    try:
        return int(head)
    except (TypeError, ValueError):
        return 0


@dataclass
class RecoveryResult:
    restored: bool = False        # a snapshot was loaded
    source: str = ""              # snapshot file name (or "" = journal only)
    replayed: int = 0             # journal records applied
    skipped: int = 0              # records below the covered position
    torn: int = 0                 # torn segment tails tolerated
    fallback: int = 0             # snapshots rejected before one loaded
    errors: int = 0               # records that failed to apply
    first_error_position: Optional[int] = None  # earliest errored record
    round: int = 0                # MIX round after recovery
    collective_round: int = 0     # the collective epoch ("cmix")
    local_id: int = 0             # the id watermark (standalone idgen)
    position: int = 0             # journal position the writer resumes at
    next_seq: int = 0             # next free journal segment seq
    restore_sec: float = 0.0      # snapshot read + unpack
    replay_sec: float = 0.0       # journal scan + replay, to a device sync
    segments: List[SegmentInfo] = field(default_factory=list)

    def get_status(self) -> Dict[str, str]:
        return {
            "recovery_restored": str(int(self.restored)),
            "recovery_source": self.source or "journal",
            "recovery_replayed": str(self.replayed),
            "recovery_torn": str(self.torn),
            "recovery_fallback": str(self.fallback),
            "recovery_errors": str(self.errors),
            "recovery_round": str(self.round),
            "recovery_collective_round": str(self.collective_round),
            "recovery_restore_ms": f"{self.restore_sec * 1e3:.3f}",
            "recovery_replay_ms": f"{self.replay_sec * 1e3:.3f}",
        }


def _load_snapshot(slot, dirpath: str, manifest: Manifest,
                   result: RecoveryResult, registry) -> None:
    """Newest-first snapshot restore with fallback (step 1)."""
    from jubatus_tpu_torch.framework.save_load import load_model
    from jubatus_tpu_torch.framework.server_base import USER_DATA_VERSION
    for ent in manifest.snapshots:
        path = os.path.join(dirpath, ent.get("file", ""))
        try:
            with open(path, "rb") as fp:
                data = load_model(fp, server_type=slot.args.type,
                                  expected_config=slot.config_str,
                                  user_data_version=USER_DATA_VERSION)
            slot.driver.unpack(data)
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 - ANY bad image falls back
            result.fallback += 1
            registry.inc("recovery_fallback_total")
            log.warning("snapshot %s rejected (%s); falling back", path, e)
            try:  # unpack may have half-mutated the driver: reset it
                slot.driver.clear()
            except Exception:
                log.exception("driver reset after failed unpack ALSO "
                              "failed; continuing with undefined state")
            continue
        result.restored = True
        result.source = ent.get("file", "")
        result.position = int(ent.get("covered_position", 0))
        result.round = int(ent.get("round", 0))
        result.collective_round = int(ent.get("collective_round", 0))
        result.local_id = int(ent.get("local_id", 0))
        log.info("recovered snapshot %s: journal position %d, round %d",
                 result.source, result.position, result.round)
        return
    if manifest.snapshots:
        log.error("every retained snapshot was invalid; recovering from "
                  "the journal alone (records below the oldest surviving "
                  "segment are LOST)")


def _apply(slot, rec: Any, state: RecoveryResult) -> bool:
    """Apply one journal record; returns True when it mutated the model."""
    if not isinstance(rec, dict):
        raise ValueError(f"malformed journal record: {type(rec).__name__}")
    kind = rec.get("k")
    if kind == "train":
        frames = [(bytes(m), int(o)) for m, o in rec.get("f") or []]
        drv = slot.driver
        if getattr(drv, "_fast", None) is not None:
            # one C convert + one device step per journaled window:
            # bitwise the recorded step, whatever window the live run made
            drv.train_converted_batch(drv.convert_raw_batch(frames))
        else:
            # a config the C converter does not cover: decode each frame
            # and train it as the live decoded route did
            import msgpack

            from jubatus_tpu_torch.framework.service import SERVICES
            fn = SERVICES[slot.args.type].methods["train"].fn
            for m, _o in frames:
                params = msgpack.unpackb(
                    m, raw=False, strict_map_key=False,
                    unicode_errors="surrogateescape")[3]
                fn(slot, *params[1:])
        return True
    if kind == "u":
        from jubatus_tpu_torch.framework.service import SERVICES
        method = SERVICES[slot.args.type].methods[rec["m"]]
        method.fn(slot, *rec.get("a", []))
        return True
    if kind == "diff":
        from jubatus_tpu_torch.mix import codec
        from jubatus_tpu_torch.mix.linear_mixer import MIX_WIRE_VERSIONS
        # a v3 body dequantizes on the driver's device: the card's kernel
        obj = codec.decode(rec["p"], slot.driver.device)
        if obj.get("protocol_version") not in MIX_WIRE_VERSIONS:
            log.warning("journaled diff speaks protocol %r; skipped",
                        obj.get("protocol_version"))
            return False
        rnd = obj.get("round")
        if rnd is not None and int(rnd) <= state.round:
            return False          # round-id guard: never fold twice
        slot.driver.put_diff(obj["diff"])
        if rnd is not None:
            state.round = int(rnd)
        return True
    if kind == "clear":
        slot.driver.clear()
        return True
    if kind == "drv":
        m = rec.get("m")
        if m not in DRIVER_REPLAY or not hasattr(slot.driver, m):
            raise ValueError(f"journal record drv {m!r}: the "
                             f"{slot.args.type} driver has no such mutation")
        DRIVER_REPLAY[m](slot, *rec.get("a", []))
        return True
    if kind == "cmix":
        # a collective round: the fold re-runs where it ran live; its
        # epoch must survive the crash so the mixer resumes counting
        cr = rec.get("cr")
        if cr is not None and int(cr) <= state.collective_round:
            return False          # epoch guard: never fold twice
        dm = getattr(slot.driver, "device_mix", None)
        if dm is not None:
            dm()
        if cr is not None:
            state.collective_round = int(cr)
        return True
    raise ValueError(f"unknown journal record kind {kind!r}")


def recover(slot, dirpath: str,
            registry: Optional["_metrics.Registry"] = None) -> RecoveryResult:
    reg = registry if registry is not None else _metrics.GLOBAL
    result = RecoveryResult()
    t0 = time.perf_counter()
    _load_snapshot(slot, dirpath, Manifest.load(dirpath), result, reg)
    slot.driver.device_sync()
    t1 = time.perf_counter()
    result.restore_sec = t1 - t0

    end_position = result.position
    # ONE pass over the segment files builds the writer's SegmentInfo
    # list AND replays; scan_segment_records owns torn-tail handling
    for info, records in scan_segment_records(dirpath, truncate_torn=True,
                                              registry=reg):
        result.next_seq = max(result.next_seq, info.seq + 1)
        result.segments.append(info)
        if info.torn:
            result.torn += 1
        for offset, rec in enumerate(records):
            pos = info.start + offset
            # covered records count too: their ids live in the snapshot,
            # whose entry may predate the local_id field
            result.local_id = max(result.local_id,
                                  _record_id_watermark(rec))
            if pos < result.position:
                result.skipped += 1
                continue
            if pos > end_position:
                # segments below were truncated past our snapshot's
                # coverage (possible only after a fallback): the missing
                # records are gone — log loudly, keep serving
                log.error("journal gap: expected position %d, next record "
                          "is %d (%d records lost)", end_position, pos,
                          pos - end_position)
            try:
                if _apply(slot, rec, result):
                    slot.update_count += 1
            except KernelError:
                raise             # no CPU fallback: the boot fails
            except Exception:
                result.errors += 1
                if result.first_error_position is None:
                    result.first_error_position = pos
                reg.inc("recovery_replay_errors_total")
                log.exception("journal record %d failed to replay; "
                              "continuing", pos)
            result.replayed += 1
            end_position = pos + 1
    slot.driver.device_sync()
    result.replay_sec = time.perf_counter() - t1
    result.position = max(result.position, end_position)
    if result.local_id:
        with slot._id_lock:
            slot._local_id = max(slot._local_id, result.local_id)
    reg.inc("recovery_replayed_records_total", result.replayed)

    if result.replayed:
        log.info("journal replay: %d records applied (%d skipped as "
                 "covered, %d errors) in %.3f s, resuming at position %d, "
                 "round %d", result.replayed, result.skipped, result.errors,
                 result.replay_sec, result.position, result.round)
    return result
