"""The port's per-process model host (counterpart of
jubatus_tpu/framework/server_base.py, one model per process).

It builds the engine's driver on its device, holds the model lock, the
raw-train dispatcher and the read lane (the JAX server's default model
slot), counts updates, and answers the common RPCs: get_config, save,
load, clear, get_status and do_mix.  In a cluster (--coordinator) it also
holds the membership client, the mixer and an id generator drawing from
the coordinator's create_id; standalone it has none of them.  With
--journal it holds the durability plane (durability/): init_durability
recovers the model from the journal directory before the server is
routable, then the journal takes every applied update and the
snapshotter writes the model in the background.  Model files use the
reference format (framework/save_load.py) with the JAX package's naming
and user-data version, so a file saved by either package loads in the
other; `save` publishes through tmp + fsync + rename + directory fsync
under a flock on the file.
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
from jubatus_tpu_torch.batching.arenas import ArenaPool
from jubatus_tpu_torch.device import device_telemetry
from jubatus_tpu_torch.durability import write_file_durably
from jubatus_tpu_torch.durability.journal import check_writable
from jubatus_tpu_torch.framework.dispatch import IngestPipeline
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.models import create_driver
from jubatus_tpu_torch.models.classifier import train_scan
from jubatus_tpu_torch.models.regression import \
    train_scan as regression_train_scan
from jubatus_tpu_torch.ops.candidates import ivf_probe, sig_probe
from jubatus_tpu_torch.ops.lsh import (dense_dots, dense_topk,
                                       lsh_signature, minhash_signature,
                                       sig_counts, sig_scores, sig_topk)
from jubatus_tpu_torch.parallel.quantized import (dequantize_int8,
                                                  quantize_int8)
from jubatus_tpu_torch.utils.metrics import GLOBAL as metrics
from jubatus_tpu_torch.utils.rwlock import RWLock

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
    datadir: str = "/tmp"
    configpath: str = ""
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
    # the read lane's window (0: no lane)
    read_batch_window_us: float = 0.0
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
        # readers (classify, get_labels, save) share; updates and the
        # dispatch thread's fused steps are exclusive
        self.model_lock = RWLock()
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
        if self.mixer is not None:
            self.mixer.updated()

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
        return init_durability(self)

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
        if self.membership is not None:
            # closing the session withdraws our ephemeral registrations
            self.membership.close()

    def get_status(self) -> Dict[str, Dict[str, str]]:
        st: Dict[str, str] = {
            "type": self.args.type,
            "name": self.args.name,
            "datadir": self.args.datadir,
            "update_count": str(self.update_count),
            "uptime": str(int(time.time() - self.start_time)),
            "pid": str(os.getpid()),
            "version": jubatus_tpu_torch.__version__,
            "is_standalone": str(int(self.membership is None)),
            "device": str(self.driver.device),
            # whether the native wire converter covers this config
            "fast_path": str(getattr(self.driver, "_fast", None) is not None),
            # the one dispatch mode the port has (the JAX server's default)
            "dispatch_mode": "threaded",
            # whether raw train frames go through the IngestPipeline
            "ingest_pipeline": str(int(self.dispatcher is not None)),
            # its fixed settings, the JAX server's defaults
            "batch_max": str(IngestPipeline.MAX_COALESCE),
            "batch_window_us": str(IngestPipeline.MAX_WAIT_S * 1e6),
            "ingest_depth": str(IngestPipeline.DEPTH),
            "arena_pool": str(ArenaPool.MAX_PER_SIZE),
            # the read lane's window, 0 when there is no lane
            "read_batch_window_us": str(
                self.read_dispatch.window_s * 1e6
                if self.read_dispatch is not None else 0),
            # durability: the flag always; the journal's, snapshotter's
            # and recovery's keys below when it is on
            "journal_enabled": str(int(self.journal is not None)),
            # the index knobs; a driver with a live index overrides
            # "index" with its kind and adds its index_* detail, so "off"
            # with no detail means declined or never asked
            "index": "off",
            "index_probes": str(self.args.index_probes),
            # the partition plane: the routing mode always; the manager's
            # ring version, epoch, range and resident rows when it runs
            "routing": self.args.routing,
        }
        if self.dispatcher is not None:
            st["ingest_windows"] = str(self.dispatcher.windows)
            st["ingest_frames"] = str(self.dispatcher.frames)
            st["ingest_stalls"] = str(self.dispatcher.stalls)
        for name, n in kernel_launches().items():
            st[f"kernel_launches.{name}"] = str(n)
        for k, v in device_telemetry(self.driver.device).items():
            st[k] = str(v)
        pool = getattr(self.driver, "arena_pool", None)
        if pool is not None:
            st["arena_pool_hit_total"] = str(pool.hits)
            st["arena_pool_miss_total"] = str(pool.misses)
        st.update(self.driver.get_status())
        if self.partition_manager is not None:
            st.update(self.partition_manager.get_status())
            st["partition_rows"] = str(len(self.driver.partition_ids()))
        # the MIX counters (mix_bytes_*_total, mix_compression_ratio,
        # retries and breakers) and the mixer's own status
        st.update(metrics.snapshot())
        # after the registry: the journal reports journal_stalled as its
        # stall REASON, which wins over the registry's 0/1 gauge
        for plane in (self.journal, self.snapshotter, self.recovery_info,
                      self.mixer):
            if plane is not None:
                st.update(plane.get_status())
        return {self.server_id: st}
