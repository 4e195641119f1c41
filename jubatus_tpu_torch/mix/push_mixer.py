"""push_mixer: decentralized pairwise gossip MIX (the port's copy of
jubatus_tpu/mix/push_mixer.py).

No master: each node picks peer candidates by a strategy and runs a
symmetric exchange with each: pull the peer's diff, merge it with ours,
apply the merge here and push it to the peer.  After the exchange the
pair agree on base + sum of both deltas.  Pairwise exchanges fold deltas
AT-LEAST-ONCE (a lost push makes one side re-export a delta the other
already folded), so this tier suits engines whose mix is idempotent;
the classifier's and regression's label counts and weights get
exactly-once rounds from linear_mixer's round ids instead.

Strategies:
  random    — one uniformly random peer per round
  broadcast — every peer each round
  skip      — peers at stride n/2, n/4, ... from self in the sorted ring

With a journal every fold is journaled as a `diff` record, as the JAX
package journals it: an acked push fold on the peer side, and the pulled
peer delta of this node's own gossip round (inside the lock hold that
applies it, committed after).  Neither carries a round id, so recovery's
round guard folds both on replay.  Every fold bumps the server's query
epoch; with the tracer on each pairwise exchange is one
`mix.gossip.exchange` record (peer, ok, strategy).

The gossip wire (pull / push) names no model, as in the JAX package: a
server under a gossip mixer mixes its default slot only, and a model
slot admitted there runs unmixed (tenancy/registry.py join_slot_cluster
gives it a DummyMixer and says so in the log).
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from jubatus_tpu_torch.mix import codec
from jubatus_tpu_torch.mix.linear_mixer import (
    MIX_PROTOCOL_VERSION, MIX_PROTOCOL_VERSION_QUANT, TriggeredMixer,
    encode_wire_diff, note_mix_bytes)
from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.rpc.client import TRANSPORT_ERRORS, Client
from jubatus_tpu_torch.rpc.resilience import (DEFAULT_RETRY, PeerHealth,
                                              RetryPolicy)

log = logging.getLogger("jubatus_tpu_torch.mix.push")


def filter_candidates(strategy: str, members: List[Tuple[str, int]],
                      me: Tuple[str, int],
                      rng: random.Random) -> List[Tuple[str, int]]:
    others = [m for m in members if tuple(m) != tuple(me)]
    if not others:
        return []
    if strategy == "random":
        return [rng.choice(others)]
    if strategy == "broadcast":
        return list(others)
    if strategy == "skip":
        ring = sorted(set(map(tuple, members)) | {tuple(me)})
        n = len(ring)
        i = ring.index(tuple(me))
        out, stride = [], n // 2
        while stride >= 1:
            peer = ring[(i + stride) % n]
            if peer != tuple(me) and peer not in out:
                out.append(peer)
            if stride == 1:
                break
            stride //= 2
        return [tuple(p) for p in out]
    raise ValueError(f"unknown push strategy: {strategy}")


class PushMixer(TriggeredMixer):
    # class-level v2 defaults for handler-only stubs
    quantize = False
    wire_version = MIX_PROTOCOL_VERSION

    def __init__(self, server, membership, strategy: str = "random",
                 interval_sec: float = 16.0, interval_count: int = 512,
                 rpc_timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 health: Optional[PeerHealth] = None,
                 quantize: bool = False):
        super().__init__(interval_sec, interval_count)
        self.server = server
        self.membership = membership
        self.strategy = strategy
        self.rpc_timeout = rpc_timeout
        # --mix_quantize: pull/push bodies ride the v3 wire too
        self.quantize = bool(quantize)
        self.wire_version = (MIX_PROTOCOL_VERSION_QUANT if quantize
                             else MIX_PROTOCOL_VERSION)
        self.retry = retry
        self.health = health if health is not None else PeerHealth()
        self.rng = random.Random()
        self.mix_count = 0
        self.me: Tuple[str, int] = ("", 0)

    @property
    def _device(self):
        return self.server.driver.device

    # -- wire API (peer side) --------------------------------------------------

    def register_api(self, rpc_server) -> None:
        rpc_server.add("get_pull_argument", self._rpc_get_pull_argument,
                       threaded=True)
        rpc_server.add("pull", self._rpc_pull, threaded=True)
        rpc_server.add("push", self._rpc_push, threaded=True)

    def _rpc_get_pull_argument(self, _arg=0) -> Any:
        return {"protocol_version": self.wire_version, "argument": None}

    def _rpc_pull(self, _arg=None) -> Any:
        # snapshot under the lock, encode outside it
        drv = self.server.driver
        with self.server.model_lock.write():
            snap = drv.get_diff_snapshot()
        diff = drv.encode_diff(snap)
        resp = {"protocol_version": self.wire_version,
                "diff": encode_wire_diff(diff, self.quantize, self._device)}
        note_mix_bytes("sent", resp)
        return resp

    def _rpc_push(self, packed) -> bool:
        note_mix_bytes("received", packed)
        obj = codec.decode(packed, self._device)
        if obj.get("protocol_version") != self.wire_version:
            return False
        if _tracer.enabled:
            # gossip has no round ids; the durable round label is the
            # closest correlation key this tier owns
            _tracer.tag_current("mix_round", self.server.current_mix_round())
        journal = self.server.journal
        with self.server.model_lock.write():
            self.server.driver.put_diff(obj["diff"])
            # the fold changed read answers: a new query epoch
            getattr(self.server, "note_model_mutated", lambda: None)()
            if journal is not None:
                # an acked push fold must survive a crash: the pusher's
                # diff base is already consumed, so nothing re-delivers
                # it.  No round id on this tier; exactly-once across the
                # crash comes from the snapshot's covered position alone
                journal.append({"k": "diff", "p": packed},
                               self.server.current_mix_round())
        if journal is not None:
            journal.commit()
        self._reset_trigger()
        return True

    def register_active(self, ip: str, port: int) -> None:
        self.me = (ip, port)
        self.membership.register_active(ip, port)

    # -- gossip round ------------------------------------------------------------

    def try_mix(self) -> bool:
        try:
            return self._gossip_round()
        except Exception:  # noqa: BLE001 - the mixer thread must survive
            log.exception("gossip round failed")
            return False
        finally:
            # even a failed round resets the trigger, or the poll would
            # refire at 2 Hz against a coordinator that is down
            self._reset_trigger()

    def _gossip_round(self) -> bool:
        members = self.membership.get_all_nodes()
        peers = filter_candidates(self.strategy, members, self.me, self.rng)
        ok = False
        driver_cls = type(self.server.driver)
        for host, port in peers:
            if not self.health.allow((host, port)):
                continue
            t_leg = time.monotonic()
            leg_ok = False
            try:
                with Client(host, port, timeout=self.rpc_timeout,
                            retry=self.retry) as c:
                    c.call_raw("get_pull_argument", 0)
                    pulled = c.call_raw("pull", None)
                    note_mix_bytes("received", pulled)
                    peer_out = codec.decode(pulled, self._device)
                    if peer_out.get("protocol_version") != self.wire_version:
                        continue
                    # merge and apply under ONE lock hold: a train landing
                    # between them would be clobbered by put_diff's base
                    # reset
                    journal = self.server.journal
                    with self.server.model_lock.write():
                        my_diff = self.server.driver.get_diff()
                        merged = driver_cls.mix(my_diff, peer_out["diff"])
                        self.server.driver.put_diff(merged)
                        getattr(self.server, "note_model_mutated", lambda: None)()
                        if journal is not None:
                            # the pulled peer delta is folded now: nothing
                            # re-delivers it, so it is journaled like any
                            # applied fold (replay re-merges it onto the
                            # recovered base)
                            journal.append(
                                {"k": "diff",
                                 "p": {"protocol_version":
                                       MIX_PROTOCOL_VERSION,
                                       "diff": codec.encode(
                                           peer_out["diff"])}},
                                self.server.current_mix_round())
                    if journal is not None:
                        journal.commit()
                    # push folds additively with no round guard: a re-sent
                    # push would fold twice, so only the reads retry
                    c.retry = None
                    push_payload = {
                        "protocol_version": self.wire_version,
                        "diff": encode_wire_diff(merged, self.quantize,
                                                 self._device)}
                    note_mix_bytes("sent", push_payload)
                    c.call_raw("push", push_payload)
                ok = leg_ok = True
                self.health.record_success((host, port))
            except TRANSPORT_ERRORS as e:
                self.health.record_failure((host, port))
                log.warning("gossip with %s:%d failed: %s", host, port, e)
            except Exception as e:  # noqa: BLE001 - the peer answered
                self.health.record_success((host, port))
                log.warning("gossip with %s:%d failed: %s", host, port, e)
            finally:
                if _tracer.enabled:
                    # one record a pairwise exchange (pull, merge, push)
                    _tracer.record("mix.gossip.exchange",
                                   time.monotonic() - t_leg,
                                   peer=f"{host}:{port}", ok=leg_ok,
                                   strategy=self.strategy)
        if ok:
            self.mix_count += 1
        return ok

    def get_status(self) -> Dict[str, str]:
        st = {
            "mixer": f"{self.strategy}_mixer",
            "mix_count": str(self.mix_count),
            "counter": str(self.counter),
            "mix_quantize": str(int(self.quantize)),
            "mix_wire_version": str(self.wire_version),
            "mix_retry_max_attempts": str(self.retry.max_attempts
                                          if self.retry else 1),
        }
        st.update(self.health.snapshot())
        return st
