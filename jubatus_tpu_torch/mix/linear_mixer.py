"""linear_mixer: master-elected gather, fold and scatter across server
processes (the port's copy of jubatus_tpu/mix/linear_mixer.py; the same
frames, so port and JAX servers mix with each other).

  * trigger: counter >= interval_count OR (counter > 0 and elapsed >
    interval_sec), with a 0.5 s condition-wait poll; do_mix fires a round
    at once
  * a master is elected per round through the coordinator lock
    <actor>/master_lock
  * the master fans "get_diff" out to ALL actors (itself included),
    folds the diffs in member order with the driver's mix(), and fans
    "put_diff" out to all of them
  * peer RPCs on the server's own RPC server: get_diff / put_diff /
    get_model (threaded handlers: the master's self-calls must not wait
    on the event loop)
  * every frame carries the wire version (2: f32 tensors; 3: blockwise
    int8 with --mix_quantize) and the round id; a frame of another wire
    version is dropped, and the round ids make the scatter exactly-once:
    a re-delivered round is a no-op, a missed round marks the server
    behind, and its mixer thread re-fetches the model from the master

On the card, every v3 encode (get_diff's and the scatter's) runs the
quantize_int8 kernel and every v3 decode the dequantize_int8 kernel, on
the driver's device.  The diff itself goes card -> host (get_diff's
gather), host -> card (the quantizer) and back: the wire bytes are the
host codec's bit for bit.

With a journal (--journal) an applied put_diff is journaled as a `diff`
record under the same write lock as the fold and committed after it;
recovery replays it through the same round-id guard.  A straggler's
catch-up and a joiner's bootstrap replace the model, so each snapshots
at once (checkpoint_after_restore): no earlier record replays onto the
adopted model.

Every fold, catch-up and bootstrap bumps the server's query epoch
(note_model_mutated), so a cached read never outlives it.  Tracing: a
master's round is one `mix.round` span (its round, members, diffs,
`applied` puts and bytes), every attempted leg one `mix.<method>.leg`
record tagged (round, peer, ok) beside the `mix_leg.<method>` histogram,
and the peers' get_diff and put_diff handlers tag their request span
with the round, so one round can be stitched across nodes from each
node's get_traces.  The retry policy and the PeerHealth breaker are the
server's --rpc_retry_* and --breaker_* flags (mix/mixer_factory.py).

A model slot's mixer (tenancy/registry.py join_slot_cluster) names its
slot on every frame of its MIX group (`model_name`): the gather argument
carries "model", put_diff a second argument, get_model a {"model"} map,
and each peer's SlotMixRouter hands the frame to that slot's mixer.  With
`model_name` None (the default slot, a one-model server) the frames are
the legacy wire byte for byte.

A data-parallel server (parallel/dp.py, --dp_replicas) nests two MIX
levels: its get_diff and put_diff handlers fold its replicas first
(device_mix) and ship one delta for the node, and a server that does not
complete a round as master on a trigger folds its replicas itself
(_device_fold), so the replicas reconcile on every trigger.  The
collective tier's rounds (mix/collective.py) build no wire frame; their
bytes land in the same mix_bytes_{sent,received}_total counters through
note_collective_bytes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from jubatus_tpu_torch.device import DeviceLike
from jubatus_tpu_torch.mix import codec
from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.rpc.client import Client, MClient
from jubatus_tpu_torch.rpc.resilience import (DEFAULT_RETRY, PeerHealth,
                                              RetryPolicy)
from jubatus_tpu_torch.utils.metrics import GLOBAL as metrics

log = logging.getLogger("jubatus_tpu_torch.mix")

# v2: column-sparse diffs with f32 tensors
MIX_PROTOCOL_VERSION = 2
# v3: blockwise-int8 tensors (__ndq3__) in get_diff / put_diff bodies,
# spoken only with --mix_quantize; flip it cluster-wide (a v2 peer drops
# v3 frames and the other way round)
MIX_PROTOCOL_VERSION_QUANT = 3
# every version this binary can decode: model transfers are exact f32
# under both, so they interoperate even where diffs are dropped
MIX_WIRE_VERSIONS = frozenset(
    {MIX_PROTOCOL_VERSION, MIX_PROTOCOL_VERSION_QUANT})


class MixerBase:
    """The mixer interface."""

    def register_api(self, rpc_server) -> None:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def updated(self) -> None:
        raise NotImplementedError

    def mix_now(self) -> bool:
        raise NotImplementedError

    def register_active(self, ip: str, port: int) -> None:
        pass

    def bootstrap(self, server, host: str, port: int,
                  timeout: float = 30.0) -> bool:
        """Fresh-joiner model transfer from a live peer; only mixers
        whose wire serves whole models (get_model) support it."""
        return False

    def get_status(self) -> Dict[str, str]:
        return {}


class DummyMixer(MixerBase):
    """No-op mixer of a standalone process."""

    def register_api(self, rpc_server) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def updated(self) -> None:
        pass

    def mix_now(self) -> bool:
        return False


class TriggeredMixer(MixerBase):
    """The count/tick trigger: a 0.5 s condition-wait poll that fires
    try_mix() when counter >= interval_count, or when elapsed >
    interval_sec with at least one update."""

    def __init__(self, interval_sec: float = 16.0, interval_count: int = 512):
        self.interval_sec = interval_sec
        self.interval_count = interval_count
        self.counter = 0
        self.ticktime = time.monotonic()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=type(self).__name__)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def updated(self) -> None:
        with self._cond:
            self.counter += 1
            if self.counter >= self.interval_count:
                self._cond.notify_all()

    def _reset_trigger(self) -> None:
        with self._cond:
            self.counter = 0
            self.ticktime = time.monotonic()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                self._cond.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                elapsed = time.monotonic() - self.ticktime
                due = (self.counter >= self.interval_count
                       or (self.counter > 0 and elapsed > self.interval_sec))
            self.maintain()
            if due:
                self.try_mix()

    def maintain(self) -> None:
        """Per-tick upkeep on the mixer thread (LinearMixer: the
        straggler catch-up, which must not run inside an RPC handler)."""

    def try_mix(self) -> bool:
        raise NotImplementedError

    def mix_now(self) -> bool:
        return self.try_mix()


def encode_wire_diff(diff, quantize: bool, device: DeviceLike = None,
                     stats: Optional[Dict[str, Any]] = None) -> Any:
    """codec-encode a diff body for the wire.  With quantization on, every
    f32 tensor travels as blockwise int8 + absmax scales, quantized by the
    kernel on `device` (None: cuda, which raises without a card; pass the
    driver's device), and the encode's compression lands in the
    mix_compression_ratio gauge; off, the bytes are the exact v2
    encoding.  When `stats` is given, this encode's byte counts and
    roundtrip errors are added to it ("raw", "wire", "max_abs_err",
    "errs")."""
    if not quantize:
        return codec.encode(diff)
    qdiff, st = codec.quantize_tree(diff, device)
    if st["wire"]:
        metrics.set_gauge("mix_compression_ratio",
                          round(st["raw"] / st["wire"], 4))
    if stats is not None:
        for key in ("raw", "wire", "max_abs_err"):
            stats[key] = stats.get(key, 0) + st[key]
        stats.setdefault("errs", []).extend(st["errs"])
    return codec.encode(qdiff)


def note_mix_bytes(direction: str, payload) -> int:
    """Account one MIX frame in mix_bytes_{sent,received}_total."""
    n = codec.wire_size(payload)
    metrics.inc(f"mix_bytes_{direction}_total", n)
    return n


def note_collective_bytes(float_elems: int, exact_elems: int, n: int,
                          payload: str = "f32") -> int:
    """Account one collective round (mix/collective.py) in the counters
    note_mix_bytes feeds, so the bandwidth series never reads 0 when the
    collective tier serves the rounds.  No frame exists; the bytes are the
    JAX package's estimate from the payload's shape: a replica's int8 ring
    ships its float elements plus 4 bytes of scale a 16,384-element block,
    the f32 sum and the exact int/bool leaves 4 bytes an element, and a
    ring all-reduce moves a replica's payload 2 (n - 1) times."""
    if n <= 1:
        return 0
    if payload == "int8":
        from jubatus_tpu_torch.parallel.quantized import _BLOCK
        per = float_elems + 4 * ((float_elems + _BLOCK - 1) // _BLOCK)
    else:
        per = 4 * float_elems
    per += 4 * exact_elems
    total = 2 * (n - 1) * per
    metrics.inc("mix_bytes_sent_total", total)
    metrics.inc("mix_bytes_received_total", total)
    return total


def device_call(server, fn):
    """fn() where the server runs its device work (rpc/server.py
    device_call under inline dispatch; a plain call otherwise)."""
    dc = getattr(server, "device_call", None)
    return fn() if dc is None else dc(fn)


class MixProtocolMismatch(RuntimeError):
    """A peer speaks another MIX protocol version: fatal at bootstrap."""


def _addr_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


class LinearMixer(TriggeredMixer):
    # class-level defaults, so handler-only stubs built via __new__ speak
    # the stock v2 wire
    quantize = False
    wire_version = MIX_PROTOCOL_VERSION
    # the slot this mixer's frames name (None: the legacy single-model
    # wire, routed to a peer's default slot)
    model_name = None

    def __init__(self, server, membership, interval_sec: float = 16.0,
                 interval_count: int = 512, rpc_timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 health: Optional[PeerHealth] = None,
                 quantize: bool = False):
        super().__init__(interval_sec, interval_count)
        self.server = server
        self.membership = membership
        self.rpc_timeout = rpc_timeout
        self.quantize = bool(quantize)
        self.wire_version = (MIX_PROTOCOL_VERSION_QUANT if quantize
                             else MIX_PROTOCOL_VERSION)
        # transient transport faults retry within the rpc_timeout budget
        # (None: no retries); a peer that keeps failing circuit-breaks,
        # and the round ids heal it as a straggler once its probe
        # re-admits it
        self.retry = retry
        self.health = health if health is not None else PeerHealth()
        self.mix_count = 0
        self.last_mix_bytes = 0      # one scatter frame
        self.last_mix_sec = 0.0
        # the last round's stages on the master, in seconds: the gather's
        # wall (get_diff legs, with the decode and fold of the legs that
        # landed overlapping it), the decode and the fold inside it, the
        # scatter's encode and the put_diff legs' wall; and the round's
        # wire bytes over all legs
        self.last_stages: Dict[str, float] = {}
        self.last_mix_wire_bytes = 0
        # this server's own handlers, last call of each, in seconds: the
        # get_diff snapshot (lock wait included), its subtraction and its
        # wire encode (quantize included); the put_diff decode and its
        # fold (lock wait included)
        self.last_legs: Dict[str, float] = {}
        self._self_addr: Tuple[str, int] = ("127.0.0.1", 0)
        # the last round APPLIED here; makes the at-least-once scatter
        # exactly-once in effect
        self.round = 0
        self._behind = None     # (host, port) of the master to catch up from
        self._behind_gen = 0    # bumped per mark

    @property
    def _device(self):
        return self.server.driver.device

    # -- wire API (peer side) -------------------------------------------------

    def register_api(self, rpc_server) -> None:
        rpc_server.add("get_diff", self._rpc_get_diff, threaded=True)
        rpc_server.add("put_diff", self._rpc_put_diff, threaded=True)
        rpc_server.add("get_model", self._rpc_get_model, threaded=True)

    def _encode_wire_diff(self, diff) -> Any:
        return encode_wire_diff(diff, self.quantize, self._device)

    def _rpc_get_diff(self, _arg=0) -> Any:
        """The snapshot under the write lock, the subtraction, quantize
        and msgpack outside it, so trains keep flowing."""
        t0 = time.monotonic()
        drv = self.server.driver
        with self.server.model_lock.write():
            snap = drv.get_diff_snapshot()
            # the round label comes from the same critical section as the
            # snapshot: a put_diff landing during the encode below must
            # not relabel the pre-fold snapshot with the post-fold round
            snap_round = self.round
        if _tracer.enabled:
            # our round on this handler's span; the master's rides the
            # frame (a dict argument; old callers send the ignored 0)
            _tracer.tag_current("mix_round", snap_round)
            if isinstance(_arg, dict) and "r" in _arg:
                _tracer.tag_current("master_round", int(_arg["r"]))
        t1 = time.monotonic()
        diff = drv.encode_diff(snap)
        t2 = time.monotonic()
        resp = {"protocol_version": self.wire_version,
                "round": snap_round,
                "diff": self._encode_wire_diff(diff)}
        t3 = time.monotonic()
        note_mix_bytes("sent", resp)
        self.last_legs.update(get_diff_snapshot=t1 - t0,
                              get_diff_encode=t2 - t1,
                              get_diff_wire=t3 - t2)
        return resp

    def _rpc_put_diff(self, packed) -> bool:
        t0 = time.monotonic()
        note_mix_bytes("received", packed)
        obj = codec.decode(packed, self._device)
        t1 = time.monotonic()
        if obj.get("protocol_version") != self.wire_version:
            log.error("mix protocol version mismatch (peer %r, we speak "
                      "%d); diff dropped", obj.get("protocol_version"),
                      self.wire_version)
            self._update_active(False)
            return False
        rnd = obj.get("round")
        if _tracer.enabled and rnd is not None:
            # the (round, master) key off the frame: this scatter leg's
            # span joins the master's mix.put_diff.leg record on it
            _tracer.tag_current("mix_round", int(rnd))
            m = obj.get("master")
            if m:
                _tracer.tag_current("master",
                                    f"{_addr_str(m[0])}:{int(m[1])}")
        behind_from = None
        journal = self.server.journal
        journaled = False
        with self.server.model_lock.write():
            # the round check, the fold and the round advance form ONE
            # critical section: concurrent duplicate deliveries of a
            # round must not both pass the check
            if rnd is not None:
                rnd = int(rnd)
                if rnd <= self.round:
                    fresh = True          # already applied: idempotent ack
                elif rnd > self.round + 1:
                    # a whole round was missed: our base is stale, so the
                    # mixer thread re-fetches the model (maintain())
                    behind_from = obj.get("master")
                    fresh = False
                else:
                    fresh = self.server.driver.put_diff(obj["diff"])
                    # the fold changed read answers: a new query epoch
                    getattr(self.server, "note_model_mutated", lambda: None)()
                    self.round = rnd
                    journaled = self._journal_diff(journal, packed)
            else:
                fresh = self.server.driver.put_diff(obj["diff"])
                getattr(self.server, "note_model_mutated", lambda: None)()
                journaled = self._journal_diff(journal, packed)
        if journaled:
            journal.commit()
        self.last_legs.update(put_diff_decode=t1 - t0,
                              put_diff_apply=time.monotonic() - t1)
        if behind_from:
            self._mark_behind(_addr_str(behind_from[0]), int(behind_from[1]))
            self._update_active(False)
            return False
        self._reset_trigger()
        # each node owns its active registration: withdrawn while
        # obsolete, back once a diff lands
        self._update_active(bool(fresh))
        return bool(fresh)

    def _journal_diff(self, journal, packed) -> bool:
        """Journal an APPLIED scatter inside put_diff's critical section.
        Replay re-folds it through the same round-id guard, so a diff is
        never folded twice across a crash (durability/recovery.py)."""
        if journal is None:
            return False
        journal.append({"k": "diff", "p": packed}, self.round)
        return True

    def _mark_behind(self, host: str, port: int) -> None:
        self._behind = (host, port)
        self._behind_gen += 1
        with self._cond:
            self._cond.notify_all()   # wake the mixer thread promptly

    def maintain(self) -> None:
        self.catch_up_if_behind()

    def catch_up_if_behind(self) -> bool:
        """Straggler recovery on the mixer thread: the whole model from
        the master that out-rounded us, and its round.  Training here
        since our delta was last folded is discarded: a bounded loss,
        where re-contributing a folded delta would drift for good."""
        behind = self._behind
        gen = self._behind_gen
        if behind is None:
            return False
        host, port = behind
        try:
            out = _fetch_model(host, port, timeout=self.rpc_timeout,
                               retry=self.retry, model=self.model_name)
        except Exception:  # noqa: BLE001 - retried on the next mark
            log.warning("straggler catch-up from %s:%d failed (will "
                        "retry on re-mark)", host, port, exc_info=True)
            if self._behind_gen == gen:   # keep a newer concurrent mark
                self._behind = None
            return False
        with self.server.model_lock.write():
            self.server.driver.unpack(out["model"])
            getattr(self.server, "note_model_mutated", lambda: None)()
            peer_round = out.get("round")
            if peer_round is not None:
                self.round = max(self.round, int(peer_round))
        if self._behind_gen == gen:
            self._behind = None
        anchor_durability(self.server)
        self._reset_trigger()
        self._update_active(True)
        log.warning("missed mix round(s): re-bootstrapped from master "
                    "%s:%d at round %s", host, port, self.round)
        return True

    def _update_active(self, fresh: bool) -> None:
        ip, port = self._self_addr
        if port == 0:       # register_active not called yet
            return
        try:
            if fresh:
                self.membership.register_active(ip, port)
            else:
                self.membership.unregister_active(ip, port)
        except Exception:  # noqa: BLE001 - the next round re-registers
            log.warning("active-list update failed", exc_info=True)

    def _rpc_get_model(self, _arg=0) -> Any:
        """Joiner bootstrap and straggler catch-up: the whole model, exact
        f32 whatever the wire version."""
        with self.server.model_lock.read():
            packed = self.server.driver.pack()
            # the round from the same lock hold as the pack
            model_round = self.round
        return {"protocol_version": self.wire_version,
                "round": model_round,
                "model": codec.encode(packed)}

    def register_active(self, ip: str, port: int) -> None:
        self._self_addr = (ip, port)
        self.membership.register_active(ip, port)

    # -- mixer thread ---------------------------------------------------------

    def _device_fold(self) -> None:
        """The two-level MIX on a server that does not complete this
        trigger's round as master: it folds its data-parallel replicas
        itself (the master's own handlers fold them as part of the
        round)."""
        if hasattr(self.server.driver, "device_mix"):
            try:
                def fold():
                    with self.server.model_lock.write():
                        self.server.driver.device_mix()
                        # the fold changed read answers: a new query epoch
                        getattr(self.server, "note_model_mutated",
                                lambda: None)()
                device_call(self.server, fold)
            except Exception:  # noqa: BLE001 - the mixer thread survives
                log.exception("device mix failed")

    def try_mix(self) -> bool:
        won = completed = False
        try:
            lock = self.membership.master_lock()
            if lock.try_lock():
                won = True
                try:
                    completed = self.mix(lock=lock)
                    return completed
                finally:
                    try:
                        lock.unlock()
                    except Exception:  # noqa: BLE001 - dies with the session
                        log.warning("master lock unlock failed", exc_info=True)
            return False
        except Exception:  # noqa: BLE001 - the mixer thread must survive
            log.exception("mix round failed")
            return False
        finally:
            # the replicas reconcile on EVERY trigger: the completed round
            # folded them (the master's handlers), or we do it here, also
            # when we won the lock and the round raised
            if not (won and completed):
                self._device_fold()
            self._reset_trigger()

    # -- master side -----------------------------------------------------------

    def _mclient(self, members) -> MClient:
        return MClient(members, timeout=self.rpc_timeout, retry=self.retry,
                       health=self.health)

    @staticmethod
    def _leg_observer(method: str, args):
        """Every attempted leg: its time in the `mix_leg.<method>`
        histogram and, with the tracer on, a `mix.<method>.leg` record
        tagged (round, peer, ok); the round is read off the argument (the
        gather's "r", the scatter payload's "round")."""
        round_tag = None
        if args and isinstance(args[0], dict):
            round_tag = args[0].get("r", args[0].get("round"))

        def observer(hp, dt, err):
            metrics.observe(f"mix_leg.{method}", dt)
            if _tracer.enabled:
                _tracer.record(f"mix.{method}.leg", dt,
                               peer=f"{hp[0]}:{hp[1]}", round=round_tag,
                               ok=err is None)
        return observer

    def _fanout(self, members, method: str,
                *args) -> List[Tuple[Tuple[str, int], Any]]:
        """Concurrent per-host call; [(host, result)] of the successes in
        member order.  Breaker-open peers are skipped."""
        paired, errors = self._mclient(members).call_each(
            method, *args, observer=self._leg_observer(method, args))
        for hp, err in errors.items():
            log.warning("%s to %s:%d failed: %s", method, hp[0], hp[1], err)
        return paired

    def _fanout_iter(self, members, method: str, *args):
        """_fanout in COMPLETION order, as each leg lands."""
        for hp, result, err in self._mclient(members).call_each_iter(
                method, *args, observer=self._leg_observer(method, args)):
            if err is not None:
                log.warning("%s to %s:%d failed: %s",
                            method, hp[0], hp[1], err)
                continue
            yield hp, result

    def mix(self, lock=None) -> bool:
        """One master round; False only when standing down because the
        master lock vanished mid-round.  One `mix.round` span."""
        with _tracer.span("mix.round") as mix_sp:
            return self._mix_locked(lock, mix_sp)

    def _mix_locked(self, lock, mix_sp) -> bool:
        t0 = time.monotonic()
        # the list as the coordinator holds it now, not the cached one: a
        # member that joined within the cache's TTL and is left out would
        # see its diff dropped as a straggler's next round, and its trains
        # lost to the catch-up
        members = self.membership.get_all_nodes(force=True)
        mix_sp.tag("round", self.round).tag("members", len(members))
        if not members:
            return True
        driver_cls = type(self.server.driver)
        own_round = self.round
        dev = self._device

        # pipelined gather and fold: each leg is decoded the moment it
        # lands, and the member-order PREFIX of current-round diffs folds
        # eagerly.  The fold order stays the member order (a float mix is
        # not bitwise-associative); completion order changes only when
        # work happens, never the folded bytes.
        n_members = len(members)
        member_idx = {tuple(hp): i for i, hp in enumerate(members)}
        arrived = [False] * n_members
        slots: List[Optional[Tuple[Optional[int], Any]]] = [None] * n_members
        bytes_wire = 0
        raw_est = 0          # f32 bytes the quantized tensors stood for
        q_est = 0            # their int8 wire bytes
        merged = None
        n_folded = 0
        fold_ptr = 0
        decode_s = 0.0
        fold_s = 0.0

        def advance_fold():
            nonlocal fold_ptr, merged, n_folded, fold_s
            while fold_ptr < n_members and arrived[fold_ptr]:
                ent = slots[fold_ptr]
                fold_ptr += 1
                if ent is None:
                    continue
                rnd, d = ent
                if rnd is not None and rnd != own_round:
                    continue      # straggler diff: excluded from the fold
                t_f = time.monotonic()
                merged = d if merged is None else driver_cls.mix(merged, d)
                fold_s += time.monotonic() - t_f
                n_folded += 1

        # the round rides the gather frame when tracing, so the peers tag
        # their handler spans with it (old peers ignore the argument); a
        # slot's mixer always sends the map, whose model field routes it
        gather_arg = {"r": own_round} \
            if (_tracer.enabled or self.model_name) else 0
        if self.model_name:
            gather_arg["model"] = self.model_name
        for (host, port), out in self._fanout_iter(members, "get_diff",
                                                   gather_arg):
            bytes_wire += note_mix_bytes("received", out)
            t_d = time.monotonic()
            obj = codec.decode(out, dev)
            decode_s += time.monotonic() - t_d
            if obj.get("protocol_version") != self.wire_version:
                log.error("dropping diff with bad protocol version from %s:%d",
                          host, port)
                obj = None
            i = member_idx.get((host, port))
            if i is None:
                continue
            if obj is not None:
                rnd = obj.get("round")
                slots[i] = (None if rnd is None else int(rnd), obj["diff"])
                if self.quantize:
                    r_, q_ = codec.quant_estimate(obj["diff"])
                    raw_est += r_
                    q_est += q_
            arrived[i] = True
            advance_fold()
        # failed legs never arrive: release the prefix and fold the rest
        for i in range(n_members):
            arrived[i] = True
        advance_fold()
        t_gathered = time.monotonic()

        gathered = [s for s in slots if s is not None]
        if not gathered:
            return True
        # exactly-once folds: only diffs at the CURRENT round take part
        rounds = [r for r, _ in gathered if r is not None]
        current = max(rounds) if rounds else None
        if current is not None and current > own_round:
            # WE are the straggler: catch up from a node at `current` and
            # mix on the next trigger (nothing was scattered yet)
            src = next(tuple(members[i]) for i in range(n_members)
                       if slots[i] is not None and slots[i][0] == current)
            if src == self._self_addr:
                log.error("own round %d below gathered max %d but the max "
                          "came from ourselves; skipping round",
                          own_round, current)
                return True
            log.warning("master is behind (round %d < %d): catching up "
                        "from %s:%d before mixing", own_round, current,
                        src[0], src[1])
            self._mark_behind(src[0], src[1])
            self.catch_up_if_behind()
            return True
        if current is not None and current < own_round:
            # we are ahead of every gathered diff: fold only diffs at OUR
            # round (the eager fold already did); stragglers heal through
            # the behind-mark on scatter
            current = own_round
        skipped = len(gathered) - n_folded
        if skipped:
            log.warning("mix: excluding %d straggler diff(s) below round %s",
                        skipped, current)
        if merged is None:
            log.warning("mix: no current-round diffs this trigger; "
                        "skipping fold")
            return True
        # a coordinator failover may have reaped our election marker, and
        # another master may be running: stand down instead of scattering
        if lock is not None and not lock.still_held():
            log.warning("master lock lost mid-round; standing down without "
                        "put_diff")
            return False
        t_e = time.monotonic()
        packed = {"protocol_version": self.wire_version,
                  "diff": self._encode_wire_diff(merged)}
        if current is not None:
            packed["round"] = current + 1
            packed["master"] = [self._self_addr[0], self._self_addr[1]]
        scatter_bytes = codec.wire_size(packed)
        t_s = time.monotonic()
        sent = 0
        scatter_legs = 0
        # a slot's mixer names its model as a second put_diff argument, so
        # the peer's router never decodes the payload to route it
        scatter_args = (packed, self.model_name) if self.model_name \
            else (packed,)
        for _hp, fresh in self._fanout(members, "put_diff", *scatter_args):
            scatter_legs += 1
            if fresh:
                sent += 1
        t_end = time.monotonic()
        if scatter_legs:
            metrics.inc("mix_bytes_sent_total", scatter_bytes * scatter_legs)
            bytes_wire += scatter_bytes * scatter_legs
            if self.quantize:
                r_, q_ = codec.quant_estimate(merged)
                raw_est += r_ * scatter_legs
                q_est += q_ * scatter_legs
        # the round's compression: wire bytes against what the same
        # tensors cost in f32 (1.0 with --mix_quantize off)
        bytes_raw = bytes_wire - q_est + raw_est
        compression = (bytes_raw / bytes_wire) if bytes_wire else 1.0
        metrics.set_gauge("mix_compression_ratio", round(compression, 4))
        self.mix_count += 1
        self.last_mix_sec = t_end - t0
        self.last_mix_bytes = scatter_bytes
        self.last_mix_wire_bytes = bytes_wire
        self.last_stages = {"gather": t_gathered - t0, "decode": decode_s,
                            "fold": fold_s, "encode": t_s - t_e,
                            "scatter": t_end - t_s}
        metrics.inc("mix_bytes_total", self.last_mix_bytes)
        metrics.observe("mix_round", self.last_mix_sec)
        mix_sp.tag("scatter_round", packed.get("round")) \
              .tag("diffs", n_folded).tag("applied", sent) \
              .tag("bytes", self.last_mix_bytes) \
              .tag("bytes_raw", bytes_raw).tag("bytes_wire", bytes_wire) \
              .tag("compression", round(compression, 3)) \
              .tag("serialize_s", round(decode_s + t_s - t_e, 6)) \
              .tag("apply_s", round(fold_s, 6))
        log.info("mix round %d: %d diffs gathered, %d applied, %d wire "
                 "bytes (%.2fx compression), %.3fs",
                 self.mix_count, n_folded, sent, bytes_wire, compression,
                 self.last_mix_sec)
        return True

    def bootstrap(self, server, host: str, port: int,
                  timeout: float = 30.0) -> bool:
        return bootstrap_from_peer(server, host, port, timeout=timeout,
                                   model=self.model_name)

    def get_status(self) -> Dict[str, str]:
        st = {
            "mixer": "linear_mixer",
            "mix_count": str(self.mix_count),
            "counter": str(self.counter),
            "interval_count": str(self.interval_count),
            "interval_sec": str(self.interval_sec),
            "last_mix_sec": str(self.last_mix_sec),
            "last_mix_bytes": str(self.last_mix_bytes),
            "last_mix_wire_bytes": str(self.last_mix_wire_bytes),
            "mix_round": str(self.round),
            "mix_quantize": str(int(self.quantize)),
            "mix_wire_version": str(self.wire_version),
            "mix_retry_max_attempts": str(self.retry.max_attempts
                                          if self.retry else 1),
        }
        for stage, sec in self.last_stages.items():
            st[f"last_mix_{stage}_sec"] = str(sec)
        for stage, sec in self.last_legs.items():
            st[f"last_{stage}_sec"] = str(sec)
        st.update(self.health.snapshot())
        return st


def _fetch_model(host: str, port: int, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 model: Optional[str] = None) -> dict:
    """get_model and its protocol check; the answer's `model` stays
    packed (the driver's unpack consumes it).  Any known wire version is
    accepted: model payloads are exact f32 under both.  `model` names
    the slot on a multi-slot peer; the legacy 0 argument fetches its
    default slot."""
    arg = {"model": model} if model else 0
    with Client(host, port, timeout=timeout, retry=retry) as c:
        out = codec.decode(c.call_raw("get_model", arg))
    if out.get("protocol_version") not in MIX_WIRE_VERSIONS:
        raise MixProtocolMismatch(
            f"peer {host}:{port} speaks mix protocol "
            f"{out.get('protocol_version')}, we speak "
            f"{sorted(MIX_WIRE_VERSIONS)}")
    return out


def bootstrap_from_peer(server, host: str, port: int,
                        timeout: float = 30.0,
                        model: Optional[str] = None) -> bool:
    """Fresh-joiner model transfer: get_model from a live peer, and its
    mix round adopted under the same lock as the unpack (never moving
    back), so a scatter folded meanwhile does not make the joiner look
    like a straggler.  Then a snapshot anchors durability on the adopted
    model.  `server` is the slot that adopts it; `model` names the slot
    on the peer."""
    out = _fetch_model(host, port, timeout=timeout, model=model)
    mixer = getattr(server, "mixer", None)
    peer_round = out.get("round")
    with server.model_lock.write():
        server.driver.unpack(out["model"])
        getattr(server, "note_model_mutated", lambda: None)()
        if mixer is not None and peer_round is not None \
                and hasattr(mixer, "round"):
            mixer.round = max(mixer.round, int(peer_round))
    anchor_durability(server)
    return True


def anchor_durability(server) -> None:
    """Anchor durability on an adopted model (a joiner's bootstrap, a
    straggler's catch-up): snapshot now, so a crash never replays earlier
    journal records onto it (no-op without a journal)."""
    try:
        server.checkpoint_after_restore()
    except Exception:  # noqa: BLE001 - the next snapshot retries
        log.warning("snapshot after adopting a model failed", exc_info=True)
