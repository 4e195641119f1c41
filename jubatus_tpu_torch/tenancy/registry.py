"""Model-slot registry: many independent models in one server process (the
port's copy of jubatus_tpu/tenancy/registry.py).

  SlotState     the per-model state and its lifecycle: driver, model
                lock, epoch, query cache, journal namespace and
                snapshotter, mixer, raw-train dispatcher and read lane,
                save/load/clear.  JubatusServer inherits it (the host IS
                the default slot, so every single-model path and the wire
                stay as they were) and ModelSlot holds one a secondary
                model.
  ModelSlot     one admitted secondary model: its own SlotState, with the
                process-level facilities (identity, ids, device_call)
                delegated to the host.
  SlotRegistry  name -> slot map and the admission plane (create, drop,
                list; journaled through the layout's catalog; per-tenant
                slot caps).  A registry mutation never runs under a model
                write lock: _guard_no_model_lock raises
                LockDisciplineError.
  SlotMixRouter the name-routed MIX wire: get_diff / put_diff / get_model
                frames carry an optional model field; a frame without one
                (a single-model peer, the default slot's group) goes to the
                default slot.

Wire rule: argument 0 of every engine RPC, the cluster name the reference
drops, is the slot key.  A registered slot's name routes there; anything
else (the cluster name too) is the default slot.  A process with one slot
resolves in one attribute check and never peeks a frame.

Each slot's driver and tensors live on the host's device; a dropped slot's
tensors are freed with it (drop_model collects the slot's reference
cycles, so the card's allocation returns at once).  The JAX package's
standby slots and activate_model belong to its autopilot's slot migration
(ROADMAP Queue 1 item 7): the port refuses them.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.durability import write_file_durably
from jubatus_tpu_torch.durability.journal import check_writable
from jubatus_tpu_torch.framework.query_cache import create_query_cache
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.tenancy import layout
from jubatus_tpu_torch.tenancy.quotas import TRAIN, QuotaSpec
from jubatus_tpu_torch.utils import to_str
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics
from jubatus_tpu_torch.utils.rwlock import LockDisciplineError, create_rwlock

log = logging.getLogger("jubatus_tpu_torch.tenancy")

USER_DATA_VERSION = 1

# row-count TTL of the quota check: partition_ids() is O(rows), so the
# admission path reads a short-lived count instead of paying it a request
_ROWS_TTL_S = 0.5

# the JAX package's migration-plane surface, refused by name
LATER_ITEM = "7"


def later_slot_refusal(what: str) -> str:
    return (f"{what} is the autopilot's slot migration, not in the port "
            f"yet: ROADMAP Queue 1 item {LATER_ITEM}")


class SlotState:
    """The per-model half of the server: everything keyed to one model.
    Inherited by JubatusServer (the default slot) and ModelSlot."""

    def _init_slot_state(self, args, config_str: str, driver) -> None:
        self.args = args
        self.config_str = config_str
        self.driver = driver
        # readers (classify, get_labels, save) share; updates and the
        # dispatch thread's fused steps are exclusive
        self.model_lock = create_rwlock()
        self.update_count = 0
        # bumped by every model mutation; the query cache keys on it
        self.model_epoch = 0
        self.query_cache = create_query_cache(args.query_cache_entries,
                                              args.query_cache_bytes)
        # the read lane and the raw-train dispatcher
        # (framework/service.setup_slot_pipelines)
        self.read_dispatch = None
        self.dispatcher = None
        self.mixer = None            # this slot's MIX group membership
        self.cht = None              # this slot's CHT ring
        self.membership = None
        self.partition_manager = None
        # durability plane (init_durability); None while it is off
        self.journal = None
        self.snapshotter = None
        self.recovery_info = None
        self._recovered_round = 0
        self._rows_cache = (0.0, 0)

    # -- update notification --------------------------------------------------

    def event_model_updated(self) -> None:
        self.update_count += 1
        self.model_epoch += 1
        if self.mixer is not None:
            self.mixer.updated()

    def note_model_mutated(self) -> None:
        """Bump the query epoch without counting an update toward the MIX
        trigger: for the mutations that are not client updates (a MIX
        fold, a catch-up or bootstrap, a recovery, --model_file).  Call
        it after the mutation, under the write lock where one is held."""
        self.model_epoch += 1

    # -- per-tenant admission -------------------------------------------------

    def admit(self, kind: str, n: int = 1) -> None:
        """The authoritative quota check (the proxy's gate is an early
        copy).  A slot with no quota costs one attribute check; `n`
        charges a whole inline burst at once."""
        q = self.quota
        if q is None:
            return
        tq = self.host.tenant_quotas
        tq.allow(self.tenant, kind, n)
        if kind == TRAIN and q.max_rows:
            tq.check_rows(self.tenant,
                          self.host.slots.tenant_rows(self.tenant),
                          q.max_rows)

    def slot_rows(self) -> int:
        """Resident rows (row-store engines; 0 otherwise), TTL-cached."""
        ids = getattr(self.driver, "partition_ids", None)
        if ids is None:
            return 0
        ts, n = self._rows_cache
        now = time.monotonic()
        if now - ts > _ROWS_TTL_S:
            n = len(ids())
            self._rows_cache = (now, n)
        return n

    # -- durability plane -----------------------------------------------------

    def init_durability(self):
        """Recover this slot from its journal namespace, then open the
        journal and the snapshotter.  Call BEFORE the slot is routable
        (replay mutates the driver with no lock held).  Returns the
        RecoveryResult, or None when durability is off."""
        if not self.args.journal_dir:
            return None
        from jubatus_tpu_torch.durability import init_durability
        result = init_durability(self)
        # recovery may have restored or replayed state: nothing keyed to
        # the process's earlier life may be served
        self.note_model_mutated()
        return result

    def shutdown_durability(self) -> None:
        """Stop the snapshotter and close the journal (flush + fsync);
        call after the slot stops taking updates."""
        if self.snapshotter is not None:
            self.snapshotter.stop()
        if self.journal is not None:
            self.journal.close()

    def current_mix_round(self) -> int:
        """The MIX round journal records and snapshots are labelled
        with: the live mixer's round when it keeps one, else the round
        recovery restored."""
        r = getattr(self.mixer, "round", None)
        return int(self._recovered_round if r is None else r)

    def current_collective_round(self) -> int:
        """The collective epoch ("cmix", mix/collective.py) snapshots are
        labelled with: the live mixer's counter when it keeps one, else
        the epoch recovery restored."""
        cr = getattr(self.mixer, "collective_round", None)
        if cr is None:
            cr = getattr(self.recovery_info, "collective_round", 0)
        return int(cr)

    def checkpoint_after_restore(self) -> None:
        """A full-model overwrite (operator load, straggler catch-up, a
        joiner's bootstrap) supersedes every earlier journal record:
        snapshot NOW so a crash never replays them onto the restored
        model.  It also lifts the truncation floor an errored replay
        pinned and resumes the background snapshots.  Call with no model
        lock held."""
        if self.snapshotter is not None:
            self.snapshotter.snapshot_now()
            self.journal.truncate_floor = None
            self.snapshotter.start()

    # -- the common RPCs, per slot --------------------------------------------

    def get_config(self) -> str:
        return self.config_str

    def _model_path(self, model_id: str) -> str:
        return os.path.join(
            self.args.datadir,
            f"{self.server_id}_jubatus_{self.args.type}_"
            f"{self.args.name}_{model_id}.jubatus")

    def save(self, model_id: str) -> Dict[str, str]:
        import fcntl
        if not model_id or "/" in model_id:
            raise ValueError(f"invalid model id: {model_id!r}")
        path = self._model_path(model_id)
        with self.model_lock.read():
            data = self.driver.pack()
        # the flock keeps two concurrent saves of one id from interleaving
        # in one tmp file (the reference locks the model file too); tmp +
        # fsync + rename + directory fsync, or a host crash after the
        # rename can surface a missing or torn file
        with open(path + ".lock", "w") as lock_fp:
            fcntl.flock(lock_fp, fcntl.LOCK_EX)
            write_file_durably(path, lambda fp: save_model(
                fp, server_type=self.args.type, model_id=model_id,
                config=self.config_str, user_data_version=USER_DATA_VERSION,
                driver_data=data))
        return {self.server_id: path}

    def load(self, model_id: str) -> bool:
        if not model_id or "/" in model_id:
            raise ValueError(f"invalid model id: {model_id!r}")
        with open(self._model_path(model_id), "rb") as fp:
            data = load_model(fp, server_type=self.args.type,
                              expected_config=self.config_str,
                              user_data_version=USER_DATA_VERSION)
        with self.model_lock.write():
            self.driver.unpack(data)
            self.event_model_updated()
        self.checkpoint_after_restore()
        return True

    def load_file(self, path: str) -> None:
        """--model_file: the boot load of a model file either package
        saved (it must carry this server's type and config)."""
        with open(path, "rb") as fp:
            data = load_model(fp, server_type=self.args.type,
                              expected_config=self.config_str,
                              user_data_version=USER_DATA_VERSION)
        with self.model_lock.write():
            self.driver.unpack(data)
            self.note_model_mutated()
        self.checkpoint_after_restore()

    def clear(self) -> bool:
        journal = self.journal
        check_writable(journal)    # refused before the model mutates
        with self.model_lock.write():
            self.driver.clear()
            self.event_model_updated()
            if journal is not None:
                journal.append({"k": "clear"}, self.current_mix_round())
        if journal is not None:
            journal.commit()
        return True

    # -- per-slot observability -------------------------------------------------

    def slot_info(self) -> Dict[str, Any]:
        """This slot's list_models entry (wire shape)."""
        info: Dict[str, Any] = {
            "tenant": self.tenant,
            "type": self.args.type,
            "default": self.host is self,
            "update_count": self.update_count,
            "model_epoch": self.model_epoch,
            "mix_round": self.current_mix_round(),
            "rows": self.slot_rows(),
        }
        pages = getattr(self.driver, "pages", None)
        if pages is not None and getattr(pages, "spill_mode", False):
            info["pages_resident"] = pages.resident_pages_now
            info["pages_budget"] = pages.spec.resident_pages
        if self.quota is not None:
            info["quota"] = self.quota.to_wire()
        return info

    def slot_status(self) -> Dict[str, str]:
        """This slot's get_status section (flat `slot.<name>.*` keys)."""
        p = f"slot.{self.slot_name}"
        st = {
            f"{p}.tenant": self.tenant,
            f"{p}.update_count": str(self.update_count),
            f"{p}.model_epoch": str(self.model_epoch),
            f"{p}.mix_round": str(self.current_mix_round()),
            f"{p}.rows": str(self.slot_rows()),
            f"{p}.journal_enabled": str(int(self.journal is not None)),
        }
        pages = getattr(self.driver, "pages", None)
        if pages is not None and getattr(pages, "spill_mode", False):
            st[f"{p}.pages_resident"] = str(pages.resident_pages_now)
            st[f"{p}.pages_budget"] = str(pages.spec.resident_pages)
        if self.quota is not None:
            q = self.quota
            st[f"{p}.quota"] = (f"max_rows={q.max_rows},"
                                f"train_rps={q.train_rps:g},"
                                f"query_rps={q.query_rps:g}")
        return st


class ModelSlot(SlotState):
    """One admitted secondary model.  It reads as a one-model server to
    every plane that takes "the server" (driver, model lock, epoch,
    journal, mixer, args with name = the slot's name, so peer calls and
    save paths key on it); the process-level facilities are the host's."""

    def __init__(self, host, name: str, tenant: str, config_str: str,
                 driver, quota: Optional[QuotaSpec]):
        self.host = host
        self.slot_name = name
        self.tenant = tenant
        self.quota = quota
        root = host.args.journal_dir
        args = dataclasses.replace(
            host.args, name=name,
            journal_dir=layout.slot_dir(root, name) if root else "")
        self._init_slot_state(args, config_str, driver)

    # -- host delegation ------------------------------------------------------

    @property
    def server_id(self) -> str:
        return self.host.server_id

    @property
    def ip(self) -> str:
        return self.host.ip

    @property
    def dispatch_mode(self) -> str:
        return self.host.dispatch_mode

    @property
    def device_call(self):
        # where the process's device work runs (rpc/server.py), bound on
        # the host by bind_service
        return getattr(self.host, "device_call", None)

    def idgen(self) -> int:
        # ids come from the host's sequence: the coordinator's create_id
        # of the host's cluster, or its local counter
        return self.host.idgen()

    # recovery restores the standalone id watermark through these
    @property
    def _id_lock(self):
        return self.host._id_lock

    @property
    def _local_id(self) -> int:
        return self.host._local_id

    @_local_id.setter
    def _local_id(self, value: int) -> None:
        self.host._local_id = value

    # -- lifecycle ------------------------------------------------------------

    def shutdown(self, leave_cluster: bool = True) -> None:
        """Stop everything this slot owns.  Never called under a model
        lock (drop_model runs on the registry path)."""
        for what in ("partition_manager", "mixer", "dispatcher",
                     "read_dispatch"):
            plane = getattr(self, what)
            if plane is None:
                continue
            try:
                plane.stop()
            except Exception:  # noqa: BLE001 - the rest must still stop
                log.warning("slot %s: %s stop failed", self.slot_name, what,
                            exc_info=True)
        if leave_cluster:
            leave_slot_cluster(self.host, self)
        self.shutdown_durability()


# -- cluster context ----------------------------------------------------------


@dataclass
class ClusterContext:
    """What a slot needs to join the cluster under its own name: the
    coordination session and the mixer and routing knobs the host booted
    with (cli/server.py builds it; in-process tests build one too)."""

    ls: Any
    mixer_kind: str = "linear_mixer"
    interval_sec: float = 16.0
    interval_count: int = 512
    rpc_timeout: float = 10.0
    retry: Any = None
    breaker_threshold: int = 3
    breaker_cooldown: float = 5.0
    quantize: bool = False
    routing: str = "replicate"
    partition_interval: float = 1.0
    partition_batch: int = 256
    partition_grace: float = 2.0


def join_slot_cluster(host, slot: ModelSlot) -> None:
    """Register one secondary slot in the cluster under ITS name: its
    membership group, CHT ring, mixer (its MIX group) and, in partition
    mode, its partition manager.  The proxy routes by name already."""
    ctx = getattr(host, "cluster_ctx", None)
    if ctx is None:
        return
    from jubatus_tpu_torch.cluster.cht import CHT
    from jubatus_tpu_torch.cluster.membership import MembershipClient
    engine = host.args.type
    m = MembershipClient(ctx.ls, engine, slot.slot_name)
    if m.get_config() is None:
        # late joiners (and config listings) read the slot's config from
        # the coordinator, as for any cluster
        try:
            m.set_config(slot.config_str)
        except Exception:  # noqa: BLE001 - the slot serves without it
            log.warning("slot %s: config push failed", slot.slot_name,
                        exc_info=True)
    slot.membership = m
    if ctx.mixer_kind in ("linear_mixer", "collective_mixer"):
        from jubatus_tpu_torch.mix.linear_mixer import LinearMixer
        from jubatus_tpu_torch.rpc.resilience import PeerHealth
        mixer = LinearMixer(slot, m, interval_sec=ctx.interval_sec,
                            interval_count=ctx.interval_count,
                            rpc_timeout=ctx.rpc_timeout, retry=ctx.retry,
                            health=PeerHealth(
                                fail_threshold=ctx.breaker_threshold,
                                cooldown=ctx.breaker_cooldown),
                            quantize=ctx.quantize)
        # every MIX frame of this group names the slot: each peer's
        # SlotMixRouter routes it to the slot's mixer
        mixer.model_name = slot.slot_name
        if ctx.mixer_kind == "collective_mixer":
            # the slot's two-level tier: the collective fold when every
            # peer shares this node's mix group, the wire otherwise
            from jubatus_tpu_torch.mix.collective import CollectiveMixer
            mixer = CollectiveMixer(slot, m, inner=mixer,
                                    interval_sec=ctx.interval_sec,
                                    interval_count=ctx.interval_count)
    else:
        # the gossip mixers have no name-routed wire: the slot serves,
        # journals and saves, unmixed (as in the JAX package)
        from jubatus_tpu_torch.mix.linear_mixer import DummyMixer
        log.warning("slot %s: mixer kind %r has no per-slot wire; the "
                    "slot runs unmixed (use linear_mixer for "
                    "multi-tenant clusters)", slot.slot_name,
                    ctx.mixer_kind)
        mixer = DummyMixer()
    slot.mixer = mixer
    if slot._recovered_round and hasattr(mixer, "round"):
        # resume at the recovered MIX round, as the boot path does
        mixer.round = max(mixer.round, slot._recovered_round)
    if slot.recovery_info is not None and hasattr(mixer, "collective_round"):
        # and the journaled collective epoch ("cmix", mix/collective.py)
        mixer.collective_round = max(mixer.collective_round,
                                     slot.recovery_info.collective_round)
    port = host.args.rpc_port
    # a slot restored before the RPC server bound its port copied the
    # requested one; its peer calls locate it by the bound one
    slot.args.rpc_port = port
    cht = CHT(ctx.ls, engine, slot.slot_name)
    slot.cht = cht
    cht.register_node(host.ip, port)
    if ctx.routing == "partition" and hasattr(slot.driver, "partition_ids"):
        from jubatus_tpu_torch.framework.partition import PartitionManager
        manager = PartitionManager(slot, interval=ctx.partition_interval,
                                   batch=ctx.partition_batch,
                                   grace=ctx.partition_grace)
        slot.partition_manager = manager
        slot.driver.partition_owned = manager.owns
        manager.start()
    m.register_actor(host.ip, port)
    mixer.start()
    mixer.register_active(host.ip, port)


def leave_slot_cluster(host, slot: ModelSlot) -> None:
    """Withdraw a slot's cluster presence: its ephemerals belong to the
    host's live session, so they are removed explicitly, or the proxy
    would go on routing the dropped name here."""
    port = host.args.rpc_port
    if slot.membership is not None:
        for fn in (slot.membership.unregister_active,
                   slot.membership.unregister_actor):
            try:
                fn(host.ip, port)
            except Exception:  # noqa: BLE001 - best effort
                log.debug("slot %s: membership withdraw failed",
                          slot.slot_name, exc_info=True)
    if slot.cht is not None:
        try:
            slot.cht.unregister_node(host.ip, port)
        except Exception:  # noqa: BLE001 - best effort
            log.debug("slot %s: cht withdraw failed", slot.slot_name,
                      exc_info=True)


# -- registry -----------------------------------------------------------------


class SlotRegistry:
    """name -> slot map and admission.  The default slot (the host) is
    registered under the host's cluster name; resolve() of any other
    unknown name falls back to it, so the legacy wire keeps working."""

    def __init__(self, host):
        self._host = host
        # the registry tier: never taken inside a model lock
        self._lock = threading.Lock()
        self._slots: Dict[str, SlotState] = {}
        self._default: SlotState = host
        self.multi = False
        self._slots[host.args.name or ""] = host

    # -- resolution (hot path) -----------------------------------------------

    @property
    def default(self) -> SlotState:
        return self._default

    def resolve(self, name) -> SlotState:
        if not self.multi or name is None:
            return self._default
        s = self._slots.get(name if type(name) is str else to_str(name))
        return s if s is not None else self._default

    def get(self, name: str) -> Optional[SlotState]:
        return self._slots.get(name)

    def secondary(self) -> List[ModelSlot]:
        return [s for s in self._slots.values() if s is not self._default]

    def all(self) -> List[SlotState]:
        return list(self._slots.values())

    def __len__(self) -> int:
        return len(self._slots)

    def tenant_slots(self, tenant: str) -> int:
        return sum(1 for s in self._slots.values() if s.tenant == tenant)

    def tenant_rows(self, tenant: str) -> int:
        return sum(s.slot_rows() for s in self._slots.values()
                   if s.tenant == tenant)

    # -- admission ------------------------------------------------------------

    def _guard_no_model_lock(self, what: str) -> None:
        """A registry mutation under a model write lock would invert the
        registry -> model order (and deadlock against handlers resolving
        slots): fail typed, at once."""
        for s in list(self._slots.values()):
            lock = getattr(s, "model_lock", None)
            if lock is not None and getattr(
                    lock, "write_held_by_me", lambda: False)():
                raise LockDisciplineError(
                    f"{what} while holding the model write lock of slot "
                    f"{s.slot_name!r} — slot-registry mutations must run "
                    "outside every model lock (tenancy/registry.py)")

    def create_model(self, spec: Any) -> bool:
        """Admit one model.  `spec` is the wire map {"name", "tenant",
        "config" (a JSON string; the host's config when absent), "quota"}.
        Journaled through the catalog; joined to the cluster when the host
        is distributed.  Never under a model lock."""
        self._guard_no_model_lock("create_model")
        host = self._host
        if not isinstance(spec, dict):
            raise ValueError("create_model wants a map "
                             "{name, tenant?, config?, quota?}")
        spec = {to_str(k): v for k, v in spec.items()}
        if spec.get("standby"):
            raise ValueError(later_slot_refusal(
                "a create_model spec with \"standby\": true"))
        name = layout.validate_slot_name(to_str(spec.get("name", "")))
        tenant = to_str(spec.get("tenant", "") or "")
        config = spec.get("config")
        config_str = to_str(config) if config else host.config_str
        quota = QuotaSpec.from_wire(spec.get("quota"))
        if quota is None:
            quota = host.default_slot_quota(host.args)
        with self._lock:
            have = self._slots.get(name)
            if have is not None:
                # idempotent re-admission: create is broadcast with strict
                # partial failure, so a retry after one member timed out
                # must succeed where it already landed.  Another spec
                # under the same name is still an error
                if (have is not self._default and have.tenant == tenant
                        and have.config_str == config_str):
                    log.info("create_model %r: already admitted "
                             "(idempotent retry)", name)
                    return True
                raise ValueError(f"model {name!r} already exists")
            host.tenant_quotas.check_slot_count(
                tenant, self.tenant_slots(tenant))
            slot = self._build_slot(name, tenant, config_str, quota)
            self._slots[name] = slot
            self.multi = True
        # the buckets exist before the slot is routable (a restart
        # re-installs them in restore_from_catalog)
        host.tenant_quotas.configure(tenant, quota)
        try:
            join_slot_cluster(host, slot)
        except Exception:
            # a half-joined slot must not linger half-routable
            with self._lock:
                self._slots.pop(name, None)
                self.multi = len(self._slots) > 1
            slot.shutdown(leave_cluster=True)
            raise
        self._persist_catalog()
        _metrics.inc("tenant_slot_create_total")
        _metrics.set_gauge("tenant_slots", float(len(self._slots)))
        log.info("created model slot %r (tenant %r)", name, tenant)
        return True

    def _build_slot(self, name: str, tenant: str, config_str: str,
                    quota: Optional[QuotaSpec]) -> ModelSlot:
        host = self._host
        slot_args = dataclasses.replace(host.args, name=name)

        def build() -> ModelSlot:
            driver = type(host)._create_driver(slot_args,
                                               json.loads(config_str))
            s = ModelSlot(host, name, tenant, config_str, driver, quota)
            # the engine's kernels load (and build, the first time) here,
            # before the slot is routable and under no model lock
            host._warm_kernels(s.driver)
            # its namespace's recovery (replay mutates the driver with no
            # lock held: the slot is not routable yet)
            s.init_durability()
            return s

        # driver construction and replay touch the device: under inline
        # dispatch that runs where the process's device work runs
        dc = getattr(host, "device_call", None)
        slot = build() if dc is None else dc(build)
        factory = getattr(host, "_pipeline_factory", None)
        if factory is not None:
            factory(slot)
        return slot

    def drop_model(self, name: str) -> bool:
        """Retire one model: deregister it, stop its planes, close and
        DELETE its journal namespace, and journal the drop in the catalog
        so it stays dropped across restarts."""
        self._guard_no_model_lock("drop_model")
        host = self._host
        name = to_str(name)
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                # idempotent retire: a broadcast drop retried after one
                # member already took it must succeed everywhere
                log.info("drop_model %r: not present (idempotent)", name)
                return True
            if slot is self._default:
                raise ValueError("the default slot cannot be dropped")
            del self._slots[name]
            self.multi = len(self._slots) > 1
        slot.shutdown(leave_cluster=True)
        root = host.args.journal_dir
        if root:
            try:
                shutil.rmtree(layout.slot_dir(root, name))
            except FileNotFoundError:
                pass
            except OSError:
                log.warning("slot %s: namespace removal failed (will be "
                            "orphaned under %s/slots)", name, root,
                            exc_info=True)
        host.tenant_quotas.forget(
            slot.tenant, still_used=self.tenant_slots(slot.tenant) > 0)
        self._persist_catalog()
        # the slot's planes point back at it (snapshotter, dispatcher,
        # mixer): collect the cycles now, so its tensors leave the card
        # with the call rather than at some later collection
        del slot
        gc.collect()
        _metrics.inc("tenant_slot_drop_total")
        _metrics.set_gauge("tenant_slots", float(len(self._slots)))
        log.info("dropped model slot %r", name)
        return True

    def list_models(self) -> Dict[str, Any]:
        return {s.slot_name: s.slot_info() for s in self.all()}

    # -- persistence ----------------------------------------------------------

    def _persist_catalog(self) -> None:
        root = self._host.args.journal_dir
        if not root:
            return
        layout.store_catalog(root, [
            {"name": s.slot_name, "tenant": s.tenant, "config": s.config_str,
             "quota": s.quota.to_wire() if s.quota else None}
            for s in self.secondary()])

    def restore_from_catalog(self) -> int:
        """Boot-time resurrection: re-create every cataloged model, each
        recovering from its own namespace.  The cluster join comes later,
        once the host's coordination session exists (join_cluster_all).
        A catalog entry marked standby (the JAX autopilot's migration
        target) is refused, naming the item."""
        root = self._host.args.journal_dir
        if not root:
            return 0
        entries = layout.load_catalog(root)
        standby = [to_str(e.get("name", "")) for e in entries
                   if e.get("standby")]
        if standby:
            raise RuntimeError(
                f"journal root {root!r} catalogs standby slots "
                f"({', '.join(standby)}); "
                + later_slot_refusal("a standby slot"))
        n = 0
        for ent in entries:
            name = to_str(ent.get("name", ""))
            try:
                with self._lock:
                    if name in self._slots:
                        continue
                    tenant = to_str(ent.get("tenant", "") or "")
                    quota = QuotaSpec.from_wire(ent.get("quota"))
                    slot = self._build_slot(
                        name, tenant,
                        to_str(ent.get("config") or self._host.config_str),
                        quota)
                    self._slots[name] = slot
                    self.multi = True
                # re-install the tenant's buckets: the authoritative
                # admission keeps enforcing across restarts
                self._host.tenant_quotas.configure(tenant, quota)
                n += 1
            except Exception:  # noqa: BLE001 - the others still restore
                log.error("cataloged slot %r failed to restore; its "
                          "journal namespace is kept for a retry after "
                          "the config is fixed", name, exc_info=True)
        if n:
            _metrics.set_gauge("tenant_slots", float(len(self._slots)))
            log.info("restored %d model slot(s) from the catalog", n)
        return n

    def join_cluster_all(self) -> None:
        """Join every restored secondary slot to the cluster (their MIX
        groups rejoin at boot); cli/server.py calls it once membership
        and the CHT exist."""
        for slot in self.secondary():
            try:
                join_slot_cluster(self._host, slot)
            except Exception:  # noqa: BLE001 - served locally, unmixed
                log.error("slot %s: cluster join failed (serving "
                          "locally, unmixed)", slot.slot_name,
                          exc_info=True)

    def shutdown_all(self) -> None:
        """Stop every SECONDARY slot (the default slot's lifecycle is the
        host's own)."""
        for slot in self.secondary():
            try:
                slot.shutdown(leave_cluster=True)
            except Exception:  # noqa: BLE001 - the others still stop
                log.warning("slot %s: shutdown failed", slot.slot_name,
                            exc_info=True)


# -- MIX wire routing ---------------------------------------------------------


class SlotMixRouter:
    """Name-routed MIX RPCs: one get_diff / put_diff / get_model
    registration that dispatches to the slot a frame names.  Frames
    without a model field (single-model peers, the default slot's group)
    go to the default slot, so the legacy wire is untouched."""

    def __init__(self, server):
        self._server = server

    def register_api(self, rpc_server) -> None:
        # threaded, as LinearMixer.register_api: a master's self-calls
        # must not wait on the event loop
        rpc_server.add("get_diff", self._get_diff, threaded=True)
        rpc_server.add("put_diff", self._put_diff, threaded=True)
        rpc_server.add("get_model", self._get_model, threaded=True)

    def _mixer(self, model):
        mixer = self._server.slot_for(model).mixer
        if mixer is None:
            raise RuntimeError(f"no mixer bound for model "
                               f"{to_str(model) if model else 'default'!r}")
        return mixer

    @staticmethod
    def _model_of(arg) -> Optional[str]:
        if isinstance(arg, dict):
            m = arg.get("model", arg.get(b"model"))
            if m:
                return to_str(m)
        return None

    def _get_diff(self, _arg=0):
        return self._mixer(self._model_of(_arg))._rpc_get_diff(_arg)

    def _put_diff(self, packed, model=None):
        return self._mixer(model)._rpc_put_diff(packed)

    def _get_model(self, _arg=0):
        return self._mixer(self._model_of(_arg))._rpc_get_model(_arg)


# -- raw-frame slot peek ------------------------------------------------------


def peek_frame_model(msg, params_off: int) -> str:
    """The first element of a raw request frame's params array (the wire
    model name), without decoding the payload; '' on anything unexpected
    (routes to the default slot, as the decoded path does)."""
    import msgpack
    view = memoryview(msg)
    for window in (96, 4096):
        up = msgpack.Unpacker(raw=False, strict_map_key=False,
                              unicode_errors="surrogateescape")
        up.feed(view[params_off:params_off + window])
        try:
            if up.read_array_header() < 1:
                return ""
            name = up.unpack()
        except msgpack.OutOfData:
            continue
        except Exception:  # noqa: BLE001 - the default slot
            return ""
        return name if isinstance(name, str) else to_str(name)
    return ""
