"""The port's per-process model host (counterpart of
jubatus_tpu/framework/server_base.py, one model per process).

It builds the engine's driver on its device, holds the model lock, the
raw-train dispatcher and the read lane (the JAX server's default model
slot), counts updates, and answers the common RPCs: get_config, save,
load, clear, get_status, get_metrics, get_traces and do_mix.  In a
cluster (--coordinator) it also
holds the membership client, the mixer and an id generator drawing from
the coordinator's create_id; standalone it has none of them.  With
--journal it holds the durability plane (durability/): init_durability
recovers the model from the journal directory before the server is
routable, then the journal takes every applied update and the
snapshotter writes the model in the background.  Model files use the
reference format (framework/save_load.py) with the JAX package's naming
and user-data version, so a file saved by either package loads in the
other; `save` publishes through tmp + fsync + rename + directory fsync
under a flock on the file, and --model_file loads one at boot
(load_file).

The query plane: `model_epoch` counts every model mutation (an update,
a clear, a load, a MIX fold, a catch-up, a recovery), and the epoch-keyed
query cache (--query_cache_entries / --query_cache_bytes,
framework/query_cache.py) never serves an answer across one.  The
observability plane: metrics_snapshot() is the one flat counter map that
get_status merges, get_metrics returns and the exporter serves; the
tracer (--trace_ring, --slow_op_ms) and the lock-order detector
(--debug_locks) are process-wide.  The JAX server's heat, SLO and health
sections (ROADMAP Queue 1 item 7) and its secondary model slots (3.5)
are not in the port yet.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import jubatus_tpu_torch
from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _lock_monitor
from jubatus_tpu_torch.durability import write_file_durably
from jubatus_tpu_torch.durability.journal import check_writable
from jubatus_tpu_torch.framework.query_cache import create_query_cache
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.models import create_driver
from jubatus_tpu_torch.models.classifier import train_scan
from jubatus_tpu_torch.models.regression import \
    train_scan as regression_train_scan
from jubatus_tpu_torch.ops.candidates import ivf_probe, sig_probe
from jubatus_tpu_torch.ops.lsh import (dense_dots, dense_topk,
                                       lsh_signature, minhash_signature,
                                       sig_counts, sig_scores, sig_topk)
from jubatus_tpu_torch.obs.trace import TRACER
from jubatus_tpu_torch.parallel.quantized import (dequantize_int8,
                                                  quantize_int8)
from jubatus_tpu_torch.utils.metrics import GLOBAL as metrics
from jubatus_tpu_torch.utils.metrics import device_telemetry
from jubatus_tpu_torch.utils.rwlock import create_rwlock

USER_DATA_VERSION = 1

# every kernel wrapper of the port, by the name get_status reports
KERNEL_WRAPPERS = {
    "train_scan": train_scan,
    "regression_train_scan": regression_train_scan,
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


class JubatusServer:
    def __init__(self, args: ServerArgs, config: Optional[str] = None):
        if config is None:
            with open(args.configpath) as f:
                config = f.read()
        self.args = args
        self.config_str = config
        self.driver = create_driver(args.type, json.loads(config),
                                    device=args.device)
        if args.index != "off" and not self.driver.configure_index(
                args.index, probes=int(args.index_probes)):
            # a kind that does not fit the engine's method declines:
            # get_status shows index=off, the full sweep serves
            # (for ivf: also an "index" embed_dim K7 does not take, whose
            # reason the driver names)
            why = getattr(self.driver, "index_decline_reason", None)
            logging.getLogger("jubatus_tpu_torch.server").warning(
                "--index %s does not fit %s/%s%s; serving full sweeps",
                args.index, args.type, getattr(self.driver, "method", "?"),
                f" ({why})" if why else "")
        if args.debug_locks:
            # before the first model-lock acquisition, so boot work
            # (recovery replay, bootstrap) is monitored too
            _lock_monitor.enable()
        # readers (classify, get_labels, save) share; updates and the
        # dispatch thread's fused steps are exclusive
        self.model_lock = create_rwlock()
        # bumped by every model mutation; the query cache keys on it
        self.model_epoch = 0
        self.query_cache = create_query_cache(args.query_cache_entries,
                                              args.query_cache_bytes)
        # "inline" or "threaded", as bound (framework/service.py)
        self.dispatch_mode = "threaded"
        # the HTTP exporter, started by the CLI once the RPC port is bound
        self.metrics_exporter = None
        pool = getattr(self.driver, "arena_pool", None)
        if pool is not None:
            pool.configure(args.arena_pool)
        if args.trace_ring > 0 or args.slow_op_ms > 0:
            # enable-only: a second server in one process must not turn
            # off the tracing a sibling turned on
            TRACER.configure(ring=max(args.trace_ring, TRACER.ring_size),
                             slow_op_ms=args.slow_op_ms
                             or TRACER.slow_op_s * 1e3)
        # raw-train dispatcher and read lane
        # (framework/service.setup_slot_pipelines)
        self.dispatcher = None
        self.read_dispatch = None
        # durability plane (init_durability); None while it is off
        self.journal = None
        self.snapshotter = None
        self.recovery_info = None
        self._recovered_round = 0
        self.update_count = 0
        self.start_time = time.time()
        # cluster: set by cli/server.py when --coordinator is given
        self.membership = None
        self.mixer = None
        self.cht = None         # the CHT ring, registered at cluster join
        # --routing partition's range reconciler (cli/server.py)
        self.partition_manager = None
        self._local_id = 0      # idgen's counter when standalone
        self._id_lock = threading.Lock()
        # the advertised address: --eth, else the bind address (a
        # wildcard bind advertises loopback)
        self.ip = args.eth or (args.bind_address
                               if args.bind_address not in ("", "0.0.0.0")
                               else "127.0.0.1")

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

    def do_mix(self) -> bool:
        """One MIX round now (the caller flushes the ingest pipeline
        first); False standalone or when another master holds the lock."""
        if self.mixer is None:
            return False
        return self.mixer.mix_now()

    # -- durability plane ----------------------------------------------------

    def init_durability(self):
        """Bring the WAL root to layout v2, recover the model from it and
        open the journal and the snapshotter.  Call BEFORE the server is
        routable (replay mutates the driver with no lock held).  Returns
        the RecoveryResult, or None when durability is off."""
        if not self.args.journal_dir:
            return None
        from jubatus_tpu_torch.durability import init_durability
        from jubatus_tpu_torch.tenancy.layout import prepare_root
        prepare_root(self.args.journal_dir)
        result = init_durability(self)
        # recovery may have restored or replayed state: nothing keyed to
        # the process's earlier life may be served
        self.note_model_mutated()
        return result

    def current_mix_round(self) -> int:
        """The MIX round journal records and snapshots are labelled
        with: the live mixer's round when it keeps one, else the round
        recovery restored."""
        r = getattr(self.mixer, "round", None)
        return int(self._recovered_round if r is None else r)

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

    def get_config(self) -> str:
        return self.config_str

    def _model_path(self, model_id: str) -> str:
        return os.path.join(
            self.args.datadir,
            f"{self.server_id}_jubatus_{self.args.type}_"
            f"{self.args.name}_{model_id}.jubatus")

    def save(self, model_id: str) -> Dict[str, str]:
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

    def stop(self) -> None:
        """Stop the partition manager, the mixer, the snapshotter, the
        raw-train dispatcher's and the read lane's threads (queued
        requests fail with "server stopping"), close the journal (flush +
        fsync) and leave the cluster.  The snapshotter stops before the dispatcher: a
        snapshot flushes the dispatcher, which a stopped one never
        answers."""
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
        one surface and not the others."""
        out: Dict[str, str] = {}
        if self.query_cache is not None:
            out.update(self.query_cache.get_status())
        metrics.set_gauge("model_epoch", float(self.model_epoch))
        metrics.set_gauge("update_count", float(self.update_count))
        metrics.set_gauge("uptime_sec", time.time() - self.start_time)
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
            # durability: the flag always; the journal's, snapshotter's
            # and recovery's keys in metrics_snapshot when it is on
            "journal_enabled": str(int(self.journal is not None)),
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
        st.update(self.metrics_snapshot())
        return {self.server_id: st}
