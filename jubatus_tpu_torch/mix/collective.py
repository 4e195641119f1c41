"""CollectiveMixer: the collective MIX tier of a data-parallel server (the
port's copy of jubatus_tpu/mix/collective.py).

Two-level MIX:

  level 1 (this module): the replicas stacked on this server's card
    (parallel/dp.py) reconcile by the collective fold
    (parallel/collective.py: the exact f32 sum, or the int8 ring on
    csrc/quantize.cu, and the base reset) under the write lock.  No host
    gather, no msgpack, no RPC.
  level 2 (mix/linear_mixer.py): get_diff/put_diff over the wire, only for
    peers outside this node's mix group, as the coordinator's mix_group
    entries advertise them (cluster/membership.py register_mix_group).

A port member's group is its own process (`<ip>_<port>`): the fold
reaches only the replicas this process holds, so the port takes no group
name from the caller.  Each trigger picks the tier: when every peer shares
this node's group (or the server runs alone) the round is the collective
fold; otherwise the wrapped LinearMixer runs the wire round, whose
get_diff and _device_fold fold the replicas as its level-1 leg.  A JAX
member that shares a group with others still sees a port member outside
it and reaches it over the wire.

Durability: each collective round appends a `{"k": "cmix", "cr": N}`
record inside the fold's write-lock section and commits it outside, as
LinearMixer's put_diff does with its `diff` record.  Recovery replays it
through an epoch guard (durability/recovery.py): the fold re-runs at the
same point of the replayed stream, and the epoch survives the crash.

The round's time: the fold is enqueued under the lock; the card is
synchronized outside it, where the JAX package blocks on a model leaf, so
last_collective_sec covers the device's work.  The JAX package's
obs/mixstats.py split of the round comes with ROADMAP Queue 1 item 7.2;
the mixer keeps its own status fields.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from jubatus_tpu_torch.mix.linear_mixer import (LinearMixer, TriggeredMixer,
                                                device_call,
                                                note_collective_bytes)
from jubatus_tpu_torch.utils.metrics import GLOBAL as metrics

log = logging.getLogger("jubatus_tpu_torch.mix")


class CollectiveMixer(TriggeredMixer):
    """The collective tier, optionally wrapping a LinearMixer for the wire
    legs.  A standalone data-parallel server gets (server, inner=None):
    every round is the fold.  A cluster member gets its LinearMixer as
    `inner`; this wrapper owns the trigger thread and routes each round to
    the tier that reaches every peer."""

    def __init__(self, server, membership=None,
                 inner: Optional[LinearMixer] = None,
                 interval_sec: float = 16.0, interval_count: int = 512):
        super().__init__(interval_sec, interval_count)
        self.server = server
        self.membership = membership
        self.inner = inner
        # this process alone: the port has no fold across processes, so a
        # group shared by several would keep its members from mixing
        self.group_id = ""
        self.device_mix_count = 0
        self.collective_round = 0         # the journaled epoch ("cmix")
        self.last_collective_sec = 0.0    # the round's wall
        self.last_collective_share = 0.0  # its share in the fold itself
        self._local_round = 0             # the wire round without inner

    # -- the wire tier's delegates (the wrapper IS the slot's mixer) ---------

    @property
    def round(self) -> int:
        return self.inner.round if self.inner is not None \
            else self._local_round

    @round.setter
    def round(self, v: int) -> None:
        if self.inner is not None:
            self.inner.round = v
        else:
            self._local_round = v

    @property
    def model_name(self):
        return self.inner.model_name if self.inner is not None else None

    @model_name.setter
    def model_name(self, v) -> None:
        if self.inner is not None:
            self.inner.model_name = v

    def register_api(self, rpc_server) -> None:
        # the wire belongs to the inner tier; the collective tier has none
        if self.inner is not None:
            self.inner.register_api(rpc_server)

    # SlotMixRouter (tenancy/registry.py) dispatches these on slot.mixer
    def _rpc_get_diff(self, *a, **kw):
        return self.inner._rpc_get_diff(*a, **kw)

    def _rpc_put_diff(self, *a, **kw):
        return self.inner._rpc_put_diff(*a, **kw)

    def _rpc_get_model(self, *a, **kw):
        return self.inner._rpc_get_model(*a, **kw)

    def register_active(self, ip: str, port: int) -> None:
        if self.membership is not None:
            self.group_id = f"{ip}_{port}"
            try:
                self.membership.register_mix_group(self.group_id, ip, port)
            except Exception:  # noqa: BLE001 - the wire tier still reaches
                log.warning("mix_group registration failed", exc_info=True)
        if self.inner is not None:
            self.inner.register_active(ip, port)

    def bootstrap(self, server, host: str, port: int,
                  timeout: float = 30.0) -> bool:
        if self.inner is not None:
            return self.inner.bootstrap(server, host, port, timeout=timeout)
        return False

    def maintain(self) -> None:
        if self.inner is not None:
            self.inner.maintain()

    # -- tier selection ---------------------------------------------------------

    def _cross_group_due(self) -> bool:
        """True when some peer is NOT in this node's mix group: the round
        must ride the wire tier to reach it."""
        if self.inner is None or self.membership is None:
            return False
        try:
            nodes = self.membership.get_all_nodes()
            if len(nodes) <= 1:
                return False
            groups = self.membership.get_mix_groups()
        except Exception:  # noqa: BLE001 - take the tier reaching everyone
            log.warning("mix_group metadata unreadable; using the wire tier",
                        exc_info=True)
            return True
        mine = {tuple(m) for m in groups.get(self.group_id, ())}
        # a peer without the collective tier advertises no group
        return any(tuple(n) not in mine for n in nodes)

    def try_mix(self) -> bool:
        if self._cross_group_due():
            # the wire round's get_diff and _device_fold are level 1
            return self.inner.try_mix()
        return self._collective_round()

    # -- the collective round ---------------------------------------------------

    def _collective_round(self) -> bool:
        driver = self.server.driver
        if not hasattr(driver, "device_mix"):
            # a single-replica driver: the wire tier is the only fold there is
            if self.inner is not None:
                return self.inner.try_mix()
            self._reset_trigger()
            return False
        journal = getattr(self.server, "journal", None)
        journaled = False
        t0 = time.monotonic()
        try:
            def fold():
                nonlocal journaled
                with self.server.model_lock.write():
                    driver.device_mix()
                    getattr(self.server, "note_model_mutated",
                            lambda: None)()
                    self.collective_round += 1
                    if journal is not None:
                        journal.append(
                            {"k": "cmix", "cr": self.collective_round},
                            self.round)
                        journaled = True

            device_call(self.server, fold)
            t1 = time.monotonic()
            if journaled:
                journal.commit()       # the fsync outside the write lock
            t2 = time.monotonic()
            driver.device_sync()       # the fold's device work, timed
            t3 = time.monotonic()
            collective_s = (t1 - t0) + (t3 - t2)
            wall = t3 - t0
            self.device_mix_count += 1
            self.last_collective_sec = wall
            self.last_collective_share = collective_s / wall if wall else 1.0
            metrics.inc("device_mix_total", 1)
            self._note_bytes(driver)
            return True
        except Exception:  # noqa: BLE001 - the mixer thread must survive
            log.exception("collective mix round failed")
            return False
        finally:
            self._reset_trigger()

    @staticmethod
    def _note_bytes(driver) -> int:
        info = getattr(driver, "collective_payload", None)
        if info is None:
            return 0
        payload, float_elems, exact_elems = info()
        return note_collective_bytes(float_elems, exact_elems,
                                     int(getattr(driver, "ndp", 1) or 1),
                                     payload=payload)

    # -- status -----------------------------------------------------------------

    def get_status(self) -> Dict[str, str]:
        st = {
            "mixer": "collective_mixer",
            "mix_count": str(self.device_mix_count),
            "collective_round": str(self.collective_round),
            "last_collective_sec": str(round(self.last_collective_sec, 6)),
            "last_collective_share": str(round(self.last_collective_share,
                                               4)),
            "mix_group": self.group_id,
            "counter": str(self.counter),
            "interval_count": str(self.interval_count),
            "interval_sec": str(self.interval_sec),
        }
        if self.inner is not None:
            st["dcn_tier"] = "linear_mixer"
            for k, v in self.inner.get_status().items():
                st.setdefault(k, v)   # the inner's mix_round, quantize, ...
        return st
