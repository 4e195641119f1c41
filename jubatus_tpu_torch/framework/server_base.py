"""The port's per-process model host (counterpart of
jubatus_tpu/framework/server_base.py).

JubatusServer is the process's host and its default model slot: it
inherits the per-model state and its RPCs from SlotState
(tenancy/registry.py): the engine's driver on the host's device, the
model lock, the raw-train dispatcher and the read lane, the update count
and the query epoch, the durability plane, the mixer, get_config, save,
load and clear.  It hosts the slot registry too: create_model admits
more named models, each a SlotState of its own with its own driver,
tensors, lock, journal namespace, query cache and MIX group, addressed by
wire argument 0 (the cluster name the reference carries), with the
default slot for any other name; drop_model retires one and list_models
lists them.  --tenant names the default slot's tenant and the four
--quota_* flags set the host's default quotas (tenancy/quotas.py).  In a
cluster (--coordinator) it also holds the membership client, the mixer,
an id generator drawing from the coordinator's create_id and the
ClusterContext that admitted slots join the cluster with; standalone it
has none of them.  With --journal it holds the durability plane
(durability/): init_durability stamps the root's layout, recovers the
default slot from the root and every cataloged slot from its own
namespace before the server is routable; then each slot's journal takes
its applied updates and its snapshotter writes it in the background.
Model files use the reference format (framework/save_load.py) with the
JAX package's naming and user-data version, so a file saved by either
package loads in the other.  With --dp_replicas other than 1 every
slot's driver is the data-parallel one (parallel/dp.py: replicas stacked
on the device); --mix_topk is set on every slot's driver.

The query plane: `model_epoch` counts every mutation of a slot (an
update, a clear, a load, a MIX fold, a catch-up, a recovery), and the
slot's epoch-keyed query cache (--query_cache_entries /
--query_cache_bytes, framework/query_cache.py) never serves an answer
across one.  The observability plane: metrics_snapshot() is the one flat
counter map that get_status merges, get_metrics returns and the exporter
serves, with each secondary slot's series under `<key>.<slot>`; the
tracer (--trace_ring, --slow_op_ms) and the lock-order detector
(--debug_locks) are process-wide.  The JAX server's heat, SLO and health
sections are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import jubatus_tpu_torch
from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _lock_monitor
from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.models import create_driver
from jubatus_tpu_torch.models.classifier import (NNClassifierDriver,
                                                train_scan, train_scan_grid)
from jubatus_tpu_torch.models.regression import \
    train_scan as regression_train_scan
from jubatus_tpu_torch.models.regression import \
    train_scan_grid as regression_train_scan_grid
from jubatus_tpu_torch.ops.candidates import ivf_probe, sig_probe
from jubatus_tpu_torch.ops.lsh import (dense_dots, dense_topk,
                                       lsh_signature, minhash_signature,
                                       sig_counts, sig_scores, sig_topk)
from jubatus_tpu_torch.obs.trace import TRACER
from jubatus_tpu_torch.parallel.quantized import (dequantize_int8,
                                                  quantize_int8)
from jubatus_tpu_torch.tenancy.layout import prepare_root
from jubatus_tpu_torch.tenancy.quotas import QuotaSpec, TenantQuotas
# USER_DATA_VERSION: the model files' user-data version, imported from
# here by the file's readers
from jubatus_tpu_torch.tenancy.registry import (USER_DATA_VERSION,
                                                SlotRegistry, SlotState)
from jubatus_tpu_torch.utils.metrics import GLOBAL as metrics
from jubatus_tpu_torch.utils.metrics import device_telemetry

# every kernel wrapper of the port, by the name get_status reports
KERNEL_WRAPPERS = {
    "train_scan": train_scan,
    "train_scan_grid": train_scan_grid,
    "regression_train_scan": regression_train_scan,
    "regression_train_scan_grid": regression_train_scan_grid,
    "quantize_int8": quantize_int8,
    "dequantize_int8": dequantize_int8,
    "lsh_signature": lsh_signature,
    "minhash_signature": minhash_signature,
    "sig_topk": sig_topk,
    "dense_topk": dense_topk,
    "dense_dots": dense_dots,
    "sig_counts": sig_counts,
    "sig_scores": sig_scores,
    "sig_probe": sig_probe,
    "ivf_probe": ivf_probe,
}


def kernel_launches() -> Dict[str, int]:
    """Launch counters of every kernel wrapper in this process."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


# the kernel libraries (kernels/build.py) a slot of each engine launches;
# a new slot loads them before it is routable (the quantizer's too with
# --mix_quantize)
ENGINE_KERNELS = {
    "classifier": ("train_scan",),
    "regression": ("regression_scan",),
    "nearest_neighbor": ("lsh", "candidates"),
    "recommender": ("lsh", "candidates"),
    "anomaly": ("lsh", "candidates"),
}


@dataclass
class ServerArgs:
    """CLI surface (a subset of the JAX server's ServerArgs)."""
    type: str = ""
    name: str = ""
    rpc_port: int = 9199
    bind_address: str = "127.0.0.1"
    thread: int = 2
    timeout: float = 10.0
    datadir: str = "/tmp"
    configpath: str = ""
    model_file: str = ""
    eth: str = ""                # advertised address override
    device: str = "cuda"
    # MIX: the mixer's name (mix/mixer_factory.py), its trigger, the
    # coordinator's address (empty: standalone), the timeout budget of
    # server-to-server calls, and the v3 (blockwise int8) wire
    mixer: str = "linear_mixer"
    interval_sec: float = 16.0
    interval_count: int = 512
    coordinator: str = ""
    interconnect_timeout: float = 10.0
    mix_quantize: bool = False
    # the data-parallel tier (parallel/dp.py): replicas stacked on the
    # device (1: a plain driver; 0: one a local device), the columns a
    # linear diff ships a round at most (0: every touched one), and the
    # resolved tier of a standalone DP server's collective mixer, echoed
    # in get_status; the key-sharded tier (parallel/sharded.py): shards
    # stacked on the device (1: a plain driver; 0: one a local device)
    dp_replicas: int = 1
    shard_devices: int = 1
    mix_topk: int = 0
    mix_collective: bool = False
    # durability: the journal directory (empty: off), its fsync policy
    # (always|batch|off), segment rotation size, and the background
    # snapshot period (0: no timer)
    journal_dir: str = ""
    journal_fsync: str = "batch"
    journal_segment_bytes: int = 64 << 20
    snapshot_interval_sec: float = 60.0
    # the train routes: fused-step width bound, adaptive linger ceiling
    # (0: no linger), the ingest pipeline's convert->dispatch depth (0:
    # the per-request TrainDispatcher) and the recycled arenas kept per
    # size class (0: none); dispatch "inline" runs the raw train path on
    # the event loop (cli/server.py resolves --dispatch auto)
    batch_max: int = 16
    batch_window_us: float = 2000.0
    ingest_depth: int = 2
    arena_pool: int = 4
    dispatch: str = "threaded"
    # the read lane's window (0: no lane) and the epoch-keyed query cache
    # (both bounds 0: off)
    read_batch_window_us: float = 0.0
    query_cache_entries: int = 0
    query_cache_bytes: int = 0
    # the sublinear query index of the row-store engines (index/):
    # off | lsh_probe (signature methods) | ivf (exact methods), and the
    # buckets (centroids) a query probes
    index: str = "off"
    index_probes: int = 4
    # the partition plane (framework/partition.py): "partition" makes the
    # CHT row ownership of the row engines (each server owns one hash
    # range, point ops go to the one owner, reads scatter-gather through
    # the proxy, a membership change hands the moved ranges off through
    # the journal); "replicate" keeps the reference behaviour
    routing: str = "replicate"
    # the handoff: rows shipped a partition_accept_rows RPC, the
    # reconciler's ring poll period, and how long the ring must have been
    # stable before rows move (above the proxies' membership TTL, 1 s)
    partition_handoff_batch: int = 256
    partition_handoff_interval_sec: float = 1.0
    partition_handoff_grace_sec: float = 2.0
    # observability, all off by default: spans kept in the ring, the
    # slow-op log's threshold, the exporter's port (negative: ephemeral),
    # the lock-order detector
    trace_ring: int = 0
    slow_op_ms: float = 0.0
    metrics_port: int = 0
    debug_locks: bool = False
    # the tenancy plane (tenancy/): the default slot's tenant and the
    # host's default per-tenant quotas, every axis 0 unlimited (no quota
    # object, one attribute check a request); create_model may set its
    # own, and quota_max_slots caps a tenant's slots at admission
    tenant: str = ""
    quota_max_slots: int = 0
    quota_max_rows: int = 0
    quota_train_rps: float = 0.0
    quota_query_rps: float = 0.0


class JubatusServer(SlotState):
    """The process host AND its default model slot: the per-model state
    and its RPCs are SlotState's (tenancy/registry.py); this class adds
    the process's identity, ids, the slot registry and admission, and the
    aggregate status and metrics surfaces."""

    def __init__(self, args: ServerArgs, config: Optional[str] = None):
        if config is None:
            with open(args.configpath) as f:
                config = f.read()
        driver = self._create_driver(args, json.loads(config))
        if args.debug_locks:
            # before the first model-lock acquisition, so boot work
            # (recovery replay, bootstrap) is monitored too
            _lock_monitor.enable()
        # the tenancy identity first: SlotState.admit reads host, tenant
        # and quota
        self.host = self
        self.slot_name = args.name or ""
        self.tenant = args.tenant or ""
        self.quota = self.default_slot_quota(args)
        self.tenant_quotas = TenantQuotas(args.quota_max_slots)
        self.tenant_quotas.configure(self.tenant, self.quota)
        self._init_slot_state(args, config, driver)
        # "inline" or "threaded", as bound (framework/service.py)
        self.dispatch_mode = "threaded"
        # the HTTP exporter, started by the CLI once the RPC port is bound
        self.metrics_exporter = None
        if args.trace_ring > 0 or args.slow_op_ms > 0:
            # enable-only: a second server in one process must not turn
            # off the tracing a sibling turned on
            TRACER.configure(ring=max(args.trace_ring, TRACER.ring_size),
                             slow_op_ms=args.slow_op_ms
                             or TRACER.slow_op_s * 1e3)
        self.start_time = time.time()
        self._local_id = 0      # idgen's counter when standalone
        self._id_lock = threading.Lock()
        # the advertised address: --eth, else the bind address (a
        # wildcard bind advertises loopback)
        self.ip = args.eth or (args.bind_address
                               if args.bind_address not in ("", "0.0.0.0")
                               else "127.0.0.1")
        # the slot registry: the default slot under the cluster name;
        # create_model admits more
        self.slots = SlotRegistry(self)
        # what an admitted slot needs to join the cluster under its own
        # name (cli/server.py sets it with --coordinator); None: the
        # slots run standalone
        self.cluster_ctx = None

    @staticmethod
    def default_slot_quota(args: ServerArgs) -> Optional[QuotaSpec]:
        """The host's default QuotaSpec from the --quota_* flags (None
        when every axis is 0, the unlimited path)."""
        spec = QuotaSpec(max_rows=int(args.quota_max_rows or 0),
                         train_rps=float(args.quota_train_rps or 0),
                         query_rps=float(args.quota_query_rps or 0))
        return spec if (spec.max_rows or spec.train_rps or spec.query_rps) \
            else None

    @staticmethod
    def _create_driver(args: ServerArgs, config: Dict[str, Any]):
        """A slot's driver on the host's device (with --dp_replicas other
        than 1 the data-parallel driver, parallel/dp.py; with
        --shard_devices other than 1 the key-sharded driver,
        parallel/sharded.py and sharded_rows.py), with the --index,
        --arena_pool and --mix_topk knobs applied."""
        from jubatus_tpu_torch.parallel.mesh import GRID_REFUSAL
        if args.dp_replicas != 1 and args.shard_devices != 1:
            raise ValueError(GRID_REFUSAL)
        if args.shard_devices != 1:
            from jubatus_tpu_torch.parallel.mesh import (make_mesh,
                                                         resolve_replicas)
            from jubatus_tpu_torch.parallel.sharded import \
                ShardedNearestNeighborDriver
            from jubatus_tpu_torch.parallel.sharded_rows import (
                ShardedAnomalyDriver, ShardedRecommenderDriver)
            sharded = {
                "nearest_neighbor": ShardedNearestNeighborDriver,
                "recommender": ShardedRecommenderDriver,
                "anomaly": ShardedAnomalyDriver,
            }
            if args.type not in sharded:
                raise ValueError(
                    "--shard_devices supports nearest_neighbor/recommender/"
                    f"anomaly (got {args.type!r})")
            n = resolve_replicas("shard_devices", args.shard_devices,
                                 args.device)
            driver = sharded[args.type](
                config, make_mesh(dp=1, shard=n, device=args.device))
        elif args.dp_replicas != 1:
            from jubatus_tpu_torch.parallel.dp import create_dp_driver
            from jubatus_tpu_torch.parallel.mesh import (make_mesh,
                                                         resolve_replicas)
            n = resolve_replicas("dp_replicas", args.dp_replicas,
                                 args.device)
            driver = create_dp_driver(args.type, config,
                                      make_mesh(dp=n, device=args.device))
        else:
            driver = create_driver(args.type, config, device=args.device)
        if args.mix_topk:
            # rides the driver's lock-free encode_diff (models/base.py
            # _sparsify_topk); inert on engines without col-sparse diffs
            driver.mix_topk = int(args.mix_topk)
        if args.index != "off" and not driver.configure_index(
                args.index, probes=int(args.index_probes)):
            # a kind that does not fit the engine's method declines:
            # get_status shows index=off, the full sweep serves
            # (for ivf: also an "index" embed_dim K7 does not take, whose
            # reason the driver names)
            why = getattr(driver, "index_decline_reason", None)
            logging.getLogger("jubatus_tpu_torch.server").warning(
                "--index %s does not fit %s/%s%s; serving full sweeps",
                args.index, args.type, getattr(driver, "method", "?"),
                f" ({why})" if why else "")
        pool = getattr(driver, "arena_pool", None)
        if pool is not None:
            pool.configure(args.arena_pool)
        return driver

    def _warm_kernels(self, driver) -> None:
        """Build (the first time) and load the kernels a slot of this
        engine launches, so a new slot's first request builds nothing
        under its model lock."""
        if driver.device.type != "cuda":
            return
        names = (("lsh",) if isinstance(driver, NNClassifierDriver)
                 else ENGINE_KERNELS[self.args.type])
        if self.args.mix_quantize or \
                getattr(driver, "mix_payload", "f32") == "int8":
            names += ("quantize",)
        build.build_all(names)
        for name in names:
            build.load(name)

    @property
    def server_id(self) -> str:
        return f"{self.ip}_{self.args.rpc_port}"

    def idgen(self) -> int:
        """A cluster-unique id: the coordinator's create_id when
        distributed, a local counter standalone."""
        if self.membership is not None:
            return self.membership.create_id()
        with self._id_lock:
            self._local_id += 1
            return self._local_id

    # -- the slot registry ----------------------------------------------------

    def slot_for(self, name=None) -> SlotState:
        """Wire argument 0 -> slot: a registered model name routes to its
        slot, anything else to the default slot.  One attribute check in
        a process with one slot."""
        return self.slots.resolve(name)

    def create_model(self, spec: Any) -> bool:
        return self.slots.create_model(spec)

    def drop_model(self, name: str) -> bool:
        return self.slots.drop_model(name)

    def list_models(self) -> Dict[str, Any]:
        return self.slots.list_models()

    def do_mix(self, name=None) -> bool:
        """One MIX round of the named slot now (the caller flushes its
        ingest pipeline first); False standalone or when another master
        holds the lock."""
        mixer = self.slots.resolve(name).mixer
        if mixer is None:
            return False
        return mixer.mix_now()

    # -- durability plane ----------------------------------------------------

    def init_durability(self):
        """Bring the WAL root to layout v2 (adopting a legacy single-model
        dir as the default slot's namespace), recover the default slot,
        then every cataloged slot from its own namespace.  Call BEFORE
        the server is routable.  Returns the default slot's
        RecoveryResult, or None when durability is off."""
        if not self.args.journal_dir:
            return None
        prepare_root(self.args.journal_dir)
        result = SlotState.init_durability(self)
        self.slots.restore_from_catalog()
        return result

    def stop(self) -> None:
        """Stop the partition manager, the mixer, the snapshotter, the
        raw-train dispatcher's and the read lane's threads (queued
        requests fail with "server stopping"), close the journal (flush +
        fsync) and leave the cluster.  The snapshotter stops before the
        dispatcher: a
        snapshot flushes the dispatcher, which a stopped one never
        answers.  The secondary slots stop first, each the same way."""
        self.slots.shutdown_all()
        if self.partition_manager is not None:
            self.partition_manager.stop()
        if self.mixer is not None:
            self.mixer.stop()
        if self.snapshotter is not None:
            self.snapshotter.stop()
        if self.dispatcher is not None:
            self.dispatcher.stop()
        if self.read_dispatch is not None:
            self.read_dispatch.stop()
        if self.journal is not None:
            self.journal.close()
        if self.metrics_exporter is not None:
            self.metrics_exporter.stop()
        if self.membership is not None:
            # closing the session withdraws our ephemeral registrations
            self.membership.close()

    def metrics_snapshot(self) -> Dict[str, str]:
        """The one flat counter map: the metrics registry and the
        subsystems' counters.  get_status merges it, get_metrics returns
        it and the exporter renders it, so a counter cannot appear in
        one surface and not the others.  Each secondary slot adds its
        series under `<key>.<slot>` (its epoch, update count, query
        cache, journal, snapshotter, recovery, mixer and driver)."""
        out: Dict[str, str] = {}
        if self.query_cache is not None:
            out.update(self.query_cache.get_status())
        metrics.set_gauge("model_epoch", float(self.model_epoch))
        metrics.set_gauge("update_count", float(self.update_count))
        metrics.set_gauge("uptime_sec", time.time() - self.start_time)
        metrics.set_gauge("tenant_slots", float(len(self.slots)))
        for k, v in device_telemetry().items():
            metrics.set_gauge(k, v)
        # the rpc, ingest, batch, read, mix and durability series
        out.update(metrics.snapshot())
        for name, n in kernel_launches().items():
            out[f"kernel_launches.{name}"] = str(n)
        pool = getattr(self.driver, "arena_pool", None)
        if pool is not None:
            out["arena_pool_hit_total"] = str(pool.hits)
            out["arena_pool_miss_total"] = str(pool.misses)
        # after the registry: the journal reports journal_stalled as its
        # stall REASON, which wins over the registry's 0/1 gauge
        for plane in (self.journal, self.snapshotter, self.recovery_info):
            if plane is not None:
                out.update(plane.get_status())
        out.update(self.driver.get_status())
        if self.mixer is not None:
            out.update(self.mixer.get_status())
        for slot in self.slots.secondary():
            sfx = slot.slot_name
            out[f"model_epoch.{sfx}"] = str(slot.model_epoch)
            out[f"update_count.{sfx}"] = str(slot.update_count)
            for sub in (slot.query_cache, slot.journal, slot.snapshotter,
                        slot.recovery_info, slot.mixer):
                if sub is not None:
                    out.update({f"{k}.{sfx}": v
                                for k, v in sub.get_status().items()})
            out.update({f"{k}.{sfx}": v
                        for k, v in slot.driver.get_status().items()})
        return out

    def get_metrics(self) -> Dict[str, Dict[str, str]]:
        """The exporter's map over RPC, keyed by server id like
        get_status (a proxy broadcast-merges both alike)."""
        return {self.server_id: self.metrics_snapshot()}

    def get_traces(self) -> Dict[str, list]:
        """The span ring over RPC ([] until --trace_ring > 0)."""
        return {self.server_id: TRACER.snapshot()}

    def get_status(self) -> Dict[str, Dict[str, str]]:
        args = self.args
        dispatcher = self.dispatcher
        st: Dict[str, str] = {
            "type": args.type,
            "name": args.name,
            "timeout": str(args.timeout),
            "threadnum": str(args.thread),
            "datadir": args.datadir,
            "update_count": str(self.update_count),
            "uptime": str(int(time.time() - self.start_time)),
            "pid": str(os.getpid()),
            "user": os.environ.get("USER", ""),
            "version": jubatus_tpu_torch.__version__,
            "is_standalone": str(int(self.membership is None)),
            "device": str(self.driver.device),
            # whether the native wire converter covers this config
            "fast_path": str(getattr(self.driver, "_fast", None) is not None),
            # the raw train path's mode: "inline" (on the event loop) or
            # "threaded" (the pipeline or the per-request dispatcher)
            "dispatch_mode": self.dispatch_mode,
            # whether raw train frames go through the IngestPipeline
            "ingest_pipeline": str(int(getattr(
                dispatcher, "accepts_raw_frames", False))),
            "batch_max": str(args.batch_max),
            "batch_window_us": str(args.batch_window_us),
            "ingest_depth": str(args.ingest_depth),
            "arena_pool": str(args.arena_pool),
            "debug_locks": str(int(_lock_monitor.enabled)),
            "model_epoch": str(self.model_epoch),
            # the read lane's window, 0 when there is no lane
            "read_batch_window_us": str(
                self.read_dispatch.window_s * 1e6
                if self.read_dispatch is not None else 0),
            "query_cache_enabled": str(int(self.query_cache is not None)),
            "mix_quantize": str(int(args.mix_quantize)),
            "mix_topk": str(args.mix_topk),
            "mix_collective": str(int(args.mix_collective)),
            # durability: the flag always; the journal's, snapshotter's
            # and recovery's keys in metrics_snapshot when it is on
            "journal_enabled": str(int(self.journal is not None)),
            # the tenancy plane: the slot count and the default slot's
            # tenant; each slot's slot.<name>.* section follows
            "tenant": self.tenant,
            "tenant_slots": str(len(self.slots)),
            # the index knobs; a driver with a live index overrides
            # "index" with its kind and adds its index_* detail, so "off"
            # with no detail means declined or never asked
            "index": "off",
            "index_probes": str(args.index_probes),
            # the partition plane: the routing mode always; the manager's
            # ring version, epoch, range and resident rows when it runs
            "routing": args.routing,
            # the tracing plane's knobs and the exporter's bound port
            "trace_ring": str(TRACER.ring_size),
            "slow_op_ms": str(round(TRACER.slow_op_s * 1e3, 3)),
            "tracing_enabled": str(int(TRACER.enabled)),
            "metrics_port": str(self.metrics_exporter.port
                                if self.metrics_exporter is not None else 0),
        }
        if getattr(dispatcher, "accepts_raw_frames", False):
            st["ingest_windows"] = str(dispatcher.windows)
            st["ingest_frames"] = str(dispatcher.frames)
            st["ingest_stalls"] = str(dispatcher.stalls)
        if self.partition_manager is not None:
            st.update(self.partition_manager.get_status())
            st["partition_rows"] = str(len(self.driver.partition_ids()))
        for slot in self.slots.all():
            st.update(slot.slot_status())
        st.update(self.metrics_snapshot())
        return {self.server_id: st}
