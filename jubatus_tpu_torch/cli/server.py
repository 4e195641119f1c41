"""Server entry point of the port.

    python -m jubatus_tpu_torch.cli.server \
        --type classifier|regression|nearest_neighbor|recommender|anomaly \
        --configpath CONFIG.json --rpc-port 9199 [--device cuda|cpu] \
        [--thread 2] [--timeout 10] [--model_file FILE] \
        [--loglevel info] [--logfile FILE] [--log_format plain|json] \
        [--name CLUSTER --coordinator HOST:PORT [--mixer linear_mixer] \
         [--interval_sec 16 --interval_count 512] [--mix_quantize] \
         [--mix_topk K] \
         [--rpc_retry_max 3] [--rpc_retry_backoff_ms 50] \
         [--breaker_threshold 3] [--breaker_cooldown 5]] \
        [--batch_max 16] [--batch_window_us 2000] [--ingest_depth 2] \
        [--arena_pool 4] [--dispatch auto|inline|threaded] \
        [--journal DIR [--journal_fsync batch] [--journal_segment_bytes N] \
         [--snapshot_interval 60]] [--read_batch_window_us W] \
        [--query_cache_entries N] [--query_cache_bytes B] \
        [--index off|lsh_probe|ivf [--index_probes 4]] \
        [--routing replicate|partition [--partition_handoff_batch 256] \
         [--partition_handoff_interval 1] [--partition_handoff_grace 2]] \
        [--trace_ring N] [--slow_op_ms MS] [--metrics_port P] \
        [--debug_locks] [--torch_profile DIR] \
        [--tenant T] [--quota_max_slots N] [--quota_max_rows N] \
        [--quota_train_rps R] [--quota_query_rps R] [--dp_replicas N] \
        [--shard_devices N]

Model state lives on --device: cuda (the default) or cpu; asking for cuda
on a machine without it fails at startup.  With --coordinator the
process joins the cluster <type>/<name>: it reads its config from the
coordinator when --configpath is absent, takes ids from the coordinator,
pulls the model from a random live member if there is one, registers
its CHT ring points (anomaly's add writes an id's two owners), an actor
and an active member, and starts its mixer thread, which mixes
every --interval_count updates or --interval_sec seconds (do_mix mixes
at once).  Its peer calls retry --rpc_retry_max attempts (<= 1: none)
with a full-jitter backoff from --rpc_retry_backoff_ms, and a peer that
fails --breaker_threshold times in a row is skipped for
--breaker_cooldown seconds.  A coordinator it cannot reach fails the
start.

The data-parallel tier (parallel/dp.py): --dp_replicas N (classifier,
regression) holds N model replicas on the one card, stacked, each
training its slice of every request in one replica-grid launch of the
scan; 0 is one replica a local card.  A standalone DP server mixes its
replicas with a CollectiveMixer (mix/collective.py) on the count/tick
trigger, the f32 fold or, with {"mix_payload": "int8"} in the config's
parameter, the int8 ring, journaled as cmix records; in a cluster
--mixer collective_mixer folds in process when every peer shares the
node's mix group and over the wire otherwise, and the linear mixer's
rounds fold each member's replicas first.  --mix_topk K ships only the K
columns of largest delta of a linear diff a round.

The key-sharded tier (parallel/sharded.py, sharded_rows.py):
--shard_devices N (nearest_neighbor, recommender, anomaly) places every
row id on one of N shards by a stable key hash, as the JAX server does;
the shards are slabs of one stacked table on the card, a
nearest_neighbor read is one K3 (or, with --index lsh_probe, one K6)
launch a shard merged on the host, and the recommender and anomaly
sweep their placed tables as they do unsharded.  0 is one shard a local
card; another --type, or --dp_replicas beside it, is refused with the
JAX server's message.

Train requests: by default their raw frames go through the ingest
pipeline (convert and dispatch threads, --ingest_depth windows deep,
--batch_max frames a window, lingering up to --batch_window_us under
load); --ingest_depth 0 converts each request on its RPC worker (one of
--thread) and coalesces them in the per-request TrainDispatcher (with
--batch_max 1 --batch_window_us 0, one device step a request).
--dispatch inline runs the raw path on the event loop, a read burst's
frames as one fused step (auto: inline exactly when the process may use
one CPU core; threaded mode sets the interpreter's switch interval to
0.5 ms, as the JAX server does).  --arena_pool bounds the recycled host
arenas a size class.

With --journal DIR the server recovers its model from DIR (the newest
valid snapshot, then the journal past it, replayed through the card's
kernels) before the RPC server is routable, journals every applied
update before acking it and snapshots in the background; a recovered
cluster member skips the joiner's bootstrap and resumes at the larger of
its mixer's and the recovered MIX round, healing missed rounds as a
straggler.  --model_file FILE loads a model file either package saved
after recovery, and wins over it: the recovered MIX round is dropped
(the file's model has none) and no bootstrap runs.  With
--read_batch_window_us W > 0 concurrent classify (estimate) calls are
served as fused sweeps (framework/dispatch.py ReadDispatcher), and so
are concurrent nearest_neighbor *_from_datum reads.
--query_cache_entries / --query_cache_bytes turn on the epoch-keyed read
cache (framework/query_cache.py).  --index lsh_probe (the signature
methods of nearest_neighbor, recommender and anomaly) or ivf (the
recommender's exact methods) serves the row engines' reads through the
sublinear candidate index (jubatus_tpu_torch/index/), probing
--index_probes buckets or centroids a query; a kind that does not fit the
engine's method is declined with a warning (get_status index=off).

--routing partition (the row engines, in a cluster; set it on every
server and proxy of the cluster) makes the CHT ring row ownership
(framework/partition.py): the server owns one hash range, the proxy
sends point ops to the one owner and scatters top-k reads, put_diff
keeps only owned or resident rows, and a PartitionManager thread hands
the rows whose owner moved off to their new owner through the journal,
--partition_handoff_batch rows an RPC, polling the ring every
--partition_handoff_interval seconds once it has been stable for
--partition_handoff_grace seconds.

Observability: --trace_ring N keeps the last N spans (get_traces),
--slow_op_ms logs every slower request with its stages, --metrics_port
serves /metrics, /metrics.json, /traces.json and /livez (negative: an
ephemeral port), --debug_locks turns on the lock-order detector, and
--torch_profile DIR records a torch.profiler trace (CPU and CUDA
activity) from the moment the server is routable until SIGTERM, then
writes it into DIR as a Chrome trace: the card's own times, which the
spans' host clocks cannot see.  The kernels build at their first launch,
inside that window (the build is host work).  --logfile writes the log
to a file that SIGHUP reopens; --log_format json puts the trace ids on
each record.

Many models in one process (tenancy/): the create_model RPC admits a
named model slot ({name, tenant?, config?, quota?}: the host's config
when none is given), with its own driver and tensors on --device, lock,
journal namespace (--journal DIR/slots/<name>), query cache, read lane,
raw-train dispatcher and, in a cluster, its own MIX group, CHT ring and
membership under its name; argument 0 of every RPC (the cluster name)
picks the slot, any other name the default one.  drop_model retires a
slot (its namespace deleted, its card memory freed), list_models lists
them; the catalog (DIR/MODELS.json) brings every slot back at boot.
--tenant names the default slot's tenant; --quota_max_slots caps a
tenant's slots, and --quota_max_rows (row engines), --quota_train_rps
and --quota_query_rps (token buckets, a second of burst) are the host's
default quotas of a slot, which a create_model quota replaces; 0 is
unlimited.  A rejected call answers `quota_exceeded: ...` and counts
tenant_quota_rejected_total.<tenant>.

The JAX server's flags of later ROADMAP Queue 1 items are accepted at
their defaults and refused otherwise, naming the item (LATER_FLAGS).

Like the JAX server's CLI it logs `... listening on host:port` and then
prints the machine-readable line `jubatus ready rpc_port=N metrics_port=M
state=ready` on stdout once it serves.  SIGTERM or SIGINT stops it.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys
import threading
from typing import Optional, Sequence, Tuple

from jubatus_tpu_torch.framework.proxy import later_refusal
from jubatus_tpu_torch.framework.server_base import JubatusServer, ServerArgs
from jubatus_tpu_torch.framework.service import SERVICES, bind_service
from jubatus_tpu_torch.mix.linear_mixer import MixProtocolMismatch
from jubatus_tpu_torch.mix.mixer_factory import check_mixer, create_mixer
from jubatus_tpu_torch.obs.trace import TRACER
from jubatus_tpu_torch.rpc.resilience import RetryPolicy
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.tenancy.registry import ClusterContext

log = logging.getLogger("jubatus_tpu_torch.server")

# (flag, its argparse keywords with the JAX server's default, the ROADMAP
# Queue 1 item that brings it)
LATER_FLAGS = (
    ("--chaos_ctl", {"action": "store_true"}, "7"),
    ("--heat_window", {"type": float, "default": 60.0}, "7"),
    ("--slo", {"default": ""}, "7"),
    ("--autopilot", {"action": "store_true"}, "7"),
    ("--autopilot_dry_run", {"action": "store_true"}, "7"),
    ("--autopilot_interval", {"type": float, "default": 5.0}, "7"),
    ("--autopilot_balloon", {"type": int, "default": 1}, "7"),
    ("--autopilot_balloon_total_pages", {"type": int, "default": 0}, "7"),
    ("--autopilot_balloon_min_pages", {"type": int, "default": 1}, "7"),
    ("--autopilot_balloon_hysteresis", {"type": float, "default": 0.25},
     "7"),
    ("--autopilot_migrate", {"type": int, "default": 1}, "7"),
    ("--autopilot_migrate_threshold", {"type": float, "default": 50.0},
     "7"),
    ("--autopilot_migrate_cooldown", {"type": float, "default": 60.0},
     "7"),
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.cli.server")
    p.add_argument("--type", required=True, choices=sorted(SERVICES))
    p.add_argument("--rpc-port", type=int, default=9199)
    p.add_argument("--listen_addr", default="0.0.0.0")
    p.add_argument("--thread", type=int, default=2,
                   help="RPC worker threads of the raw train path (each "
                        "connection's reader hands its frames to one)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="the reference's request timeout, reported in "
                        "get_status")
    p.add_argument("--datadir", default="/tmp")
    p.add_argument("--configpath", default="",
                   help="engine config; with --coordinator it may be left "
                        "out and is read from the coordinator")
    p.add_argument("--model_file", default="",
                   help="load this model file (saved by either package) "
                        "at boot, after recovery and in its place")
    p.add_argument("--name", default="")
    p.add_argument("--eth", default="", help="advertised address override")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where model state and kernels run")
    p.add_argument("--mixer", default="linear_mixer",
                   help="reconciliation strategy (mix/mixer_factory.py)")
    p.add_argument("--interval_sec", type=float, default=16.0)
    p.add_argument("--interval_count", type=int, default=512)
    p.add_argument("--coordinator", default="",
                   help="host:port of the coordination service")
    p.add_argument("--interconnect_timeout", type=float, default=10.0,
                   help="deadline budget of a server-to-server mix call, "
                        "shared by its retries")
    p.add_argument("--rpc_retry_max", type=int, default=3,
                   help="attempts a mix RPC (transport faults only; <= 1 "
                        "disables retries)")
    p.add_argument("--rpc_retry_backoff_ms", type=float, default=50.0,
                   help="base full-jitter backoff between retries "
                        "(doubling each attempt)")
    p.add_argument("--breaker_threshold", type=int, default=3,
                   help="consecutive transport failures before a peer's "
                        "circuit opens (the mix fan-out skips it)")
    p.add_argument("--breaker_cooldown", type=float, default=5.0,
                   help="seconds an open circuit waits before one "
                        "half-open probe call")
    p.add_argument("--mix_quantize", action="store_true",
                   help="ship MIX diff bodies as blockwise-int8 tensors + "
                        "f32 absmax scales (wire version 3); flip it "
                        "cluster-wide")
    p.add_argument("--mix_topk", type=int, default=0,
                   help="ship only the k largest-|delta| feature columns "
                        "of the linear mixables (classifier/regression) "
                        "per MIX round; dropped columns normally ship on "
                        "a later round, but a column a PEER ships first "
                        "adopts the cluster consensus and the local "
                        "pending delta folds away (same rule as training "
                        "that lands mid-round).  0 (default) = dense: "
                        "every touched column ships.  Per-round bitwise "
                        "replica convergence only holds at 0")
    p.add_argument("--dp_replicas", type=int, default=1,
                   help=">1: run the engine's data-parallel driver with "
                        "that many replicas stacked on the device (0 = one "
                        "a local device); the count/tick MIX trigger then "
                        "drives the collective fold")
    p.add_argument("--shard_devices", type=int, default=1,
                   help=">1: key-shard the row table (nearest_neighbor, "
                        "recommender, anomaly) over that many shards "
                        "stacked on the device (0 = one a local device)")
    p.add_argument("--batch_max", type=int, default=16,
                   help="train requests fused into one device step at most")
    p.add_argument("--batch_window_us", type=float, default=2000.0,
                   help="adaptive linger ceiling in microseconds: under "
                        "load the dispatcher may wait this long for more "
                        "requests (the controller keeps it at 0 at low "
                        "load); 0: no linger")
    p.add_argument("--ingest_depth", type=int, default=2,
                   help="converted windows the ingest pipeline keeps "
                        "between its convert and dispatch threads; 0: no "
                        "pipeline, each request converted on its RPC "
                        "worker (the per-request TrainDispatcher)")
    p.add_argument("--arena_pool", type=int, default=4,
                   help="recycled host arenas kept a size class (0: a "
                        "fresh one every window)")
    p.add_argument("--dispatch", default="auto",
                   choices=("auto", "inline", "threaded"),
                   help="raw train path: 'threaded' runs it on worker and "
                        "dispatch threads, 'inline' on the event loop (a "
                        "read burst's frames as one fused step); 'auto' "
                        "picks inline exactly when one CPU core is ours")
    p.add_argument("--journal", default="",
                   help="durability-plane directory (write-ahead journal "
                        "+ snapshots + boot crash recovery); empty "
                        "disables it.  Each server needs its OWN "
                        "directory")
    p.add_argument("--journal_fsync", default="batch",
                   choices=("always", "batch", "off"),
                   help="journal durability policy: 'always' fsyncs "
                        "every acked batch, 'batch' group-commits "
                        "(bounded records/interval), 'off' leaves it to "
                        "the OS")
    p.add_argument("--journal_segment_bytes", type=int, default=64 << 20,
                   help="journal segment rotation threshold in bytes")
    p.add_argument("--snapshot_interval", type=float, default=60.0,
                   help="background snapshot period in seconds (packs "
                        "the model under the READ lock, truncates "
                        "covered journal segments); 0 disables the timer")
    p.add_argument("--read_batch_window_us", type=float, default=0.0,
                   help="gather concurrent classify/estimate calls for "
                        "up to this many microseconds into ONE fused "
                        "sweep under one read-lock hold; 0 (default) "
                        "builds no read lane (nor does inline dispatch)")
    p.add_argument("--query_cache_entries", type=int, default=0,
                   help="entries of the epoch-keyed read cache (0 with "
                        "--query_cache_bytes 0: off); every model "
                        "mutation invalidates it, a hit answers the "
                        "encoded body with no sweep")
    p.add_argument("--query_cache_bytes", type=int, default=0,
                   help="total bytes of cached encoded answers (0: "
                        "unbounded on this axis)")
    p.add_argument("--index", default="off",
                   choices=("off", "lsh_probe", "ivf"),
                   help="sublinear candidate index of the row-store "
                        "engines' reads: lsh_probe buckets the signature "
                        "methods' signatures by band, ivf a count-sketch "
                        "k-means quantizer for the exact methods; scores "
                        "stay exact, recall is approximate, and a read "
                        "that under-fills falls back to the full sweep.  "
                        "off (default) keeps every full sweep")
    p.add_argument("--index_probes", type=int, default=4,
                   help="buckets (ivf: centroids) probed a query: the "
                        "recall knob")
    p.add_argument("--routing", default="replicate",
                   choices=("replicate", "partition"),
                   help="row placement of the row engines (recommender, "
                        "nearest_neighbor, anomaly): 'partition' makes "
                        "the CHT ring ownership (this server owns one "
                        "hash range, point ops land on their owner, the "
                        "proxy serves top-k reads scatter-gather, a "
                        "membership change hands moved ranges off "
                        "through the journal).  Set it cluster-wide, on "
                        "servers and proxies.  'replicate' (default) "
                        "keeps the reference behaviour")
    p.add_argument("--partition_handoff_batch", type=int, default=256,
                   help="rows shipped a partition_accept_rows RPC during "
                        "a range handoff (one journaled write at the "
                        "owner)")
    p.add_argument("--partition_handoff_interval", type=float, default=1.0,
                   help="seconds between partition-reconciler passes")
    p.add_argument("--partition_handoff_grace", type=float, default=2.0,
                   help="rows move only after the ring has been stable "
                        "this many seconds; keep it above the proxies' "
                        "membership TTL (1 s)")
    p.add_argument("--trace_ring", type=int, default=0,
                   help="finished spans kept in the ring (get_traces, "
                        "/traces.json); 0 (default): no spans, the "
                        "disabled path allocates nothing")
    p.add_argument("--slow_op_ms", type=float, default=0.0,
                   help="log one structured line a request slower than "
                        "this many ms, with its stages; 0 (default): off")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="serve /metrics (Prometheus text), /metrics.json, "
                        "/traces.json and /livez over HTTP on this port "
                        "(get_status and the ready line report it); 0 "
                        "(default): off; negative: an ephemeral port")
    p.add_argument("--debug_locks", action="store_true",
                   help="the lock-order detector "
                        "(jubatus_tpu_torch/analysis/lockgraph.py): "
                        "cycles, declared-order inversions and blocking "
                        "calls under the model write lock, reported as "
                        "structured ERROR logs + "
                        "lock_order_violation_total; also "
                        "JUBATUS_DEBUG_LOCKS=1")
    p.add_argument("--torch_profile", default="",
                   help="record a torch.profiler trace (CPU and CUDA "
                        "activity) from the moment the server is "
                        "routable until SIGTERM, then write it into this "
                        "directory as a Chrome trace; empty (default): "
                        "off")
    p.add_argument("--tenant", default="",
                   help="the default slot's tenant (create_model names each "
                        "admitted slot's own); quotas and "
                        "tenant_quota_rejected_total key on it")
    p.add_argument("--quota_max_slots", type=int, default=0,
                   help="a tenant's model slots at most (create_model "
                        "refuses past it); 0: unlimited")
    p.add_argument("--quota_max_rows", type=int, default=0,
                   help="the host's default cap on a tenant's resident "
                        "rows over all its slots (row-store engines), "
                        "checked at train/update admission; a "
                        "create_model quota.max_rows replaces it; 0: "
                        "unlimited")
    p.add_argument("--quota_train_rps", type=float, default=0.0,
                   help="the host's default token-bucket rate of a "
                        "tenant's train/update RPCs (a second of burst), "
                        "enforced here and early at the proxy; 0: "
                        "unlimited")
    p.add_argument("--quota_query_rps", type=float, default=0.0,
                   help="the host's default token-bucket rate of a "
                        "tenant's read RPCs; 0: unlimited")
    p.add_argument("--log_format", default="plain", choices=("plain", "json"),
                   help="'json': one JSON object a log record, with the "
                        "active trace and span ids")
    p.add_argument("--loglevel", default="info")
    p.add_argument("--logfile", default="",
                   help="log to this file (SIGHUP reopens it for rotation)")
    for flag, kw, item in LATER_FLAGS:
        p.add_argument(flag, help=later_refusal(flag, item) + "; only "
                       "the default is accepted", **kw)
    return p


def resolve_dispatch(flag: str) -> str:
    """--dispatch to the mode: auto is inline exactly when the process
    may run on one CPU core (its affinity, not the machine's count)."""
    if flag != "auto":
        return flag
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:       # no sched_getaffinity on this platform
        n_cores = os.cpu_count() or 2
    return "inline" if n_cores == 1 else "threaded"


def serve(argv: Optional[Sequence[str]] = None
          ) -> Tuple[JubatusServer, RpcServer]:
    """Build the server, join the cluster when --coordinator is given and
    start answering RPCs on a background thread; returns (server, rpc).
    rpc.stop() and then server.stop() end it."""
    parser = _parser()
    ns = parser.parse_args(argv)
    try:
        check_mixer(ns.mixer)
    except ValueError as e:
        parser.error(str(e))
    for flag, kw, item in LATER_FLAGS:
        if getattr(ns, flag[2:]) != kw.get("default", False):
            parser.error(later_refusal(flag, item))
    if not ns.configpath and not ns.coordinator:
        parser.error("--configpath is required without --coordinator")
    if ns.index_probes <= 0:
        parser.error("--index_probes must be > 0")
    args = ServerArgs(type=ns.type, name=ns.name, rpc_port=ns.rpc_port,
                      bind_address=ns.listen_addr, thread=ns.thread,
                      timeout=ns.timeout, datadir=ns.datadir,
                      configpath=ns.configpath, model_file=ns.model_file,
                      eth=ns.eth, device=ns.device,
                      mixer=ns.mixer, interval_sec=ns.interval_sec,
                      interval_count=ns.interval_count,
                      coordinator=ns.coordinator,
                      interconnect_timeout=ns.interconnect_timeout,
                      mix_quantize=ns.mix_quantize, mix_topk=ns.mix_topk,
                      dp_replicas=ns.dp_replicas,
                      shard_devices=ns.shard_devices,
                      journal_dir=ns.journal,
                      journal_fsync=ns.journal_fsync,
                      journal_segment_bytes=ns.journal_segment_bytes,
                      snapshot_interval_sec=ns.snapshot_interval,
                      batch_max=ns.batch_max,
                      batch_window_us=ns.batch_window_us,
                      ingest_depth=ns.ingest_depth,
                      arena_pool=ns.arena_pool,
                      dispatch=resolve_dispatch(ns.dispatch),
                      read_batch_window_us=ns.read_batch_window_us,
                      query_cache_entries=ns.query_cache_entries,
                      query_cache_bytes=ns.query_cache_bytes,
                      index=ns.index, index_probes=ns.index_probes,
                      routing=ns.routing,
                      partition_handoff_batch=ns.partition_handoff_batch,
                      partition_handoff_interval_sec=(
                          ns.partition_handoff_interval),
                      partition_handoff_grace_sec=ns.partition_handoff_grace,
                      trace_ring=ns.trace_ring, slow_op_ms=ns.slow_op_ms,
                      metrics_port=ns.metrics_port,
                      debug_locks=ns.debug_locks, tenant=ns.tenant,
                      quota_max_slots=ns.quota_max_slots,
                      quota_max_rows=ns.quota_max_rows,
                      quota_train_rps=ns.quota_train_rps,
                      quota_query_rps=ns.quota_query_rps)
    membership = None
    config = None
    if args.coordinator:
        from jubatus_tpu_torch.cluster.membership import MembershipClient
        membership = MembershipClient(args.coordinator, args.type, args.name)
        if not args.configpath:
            config = membership.get_config()
            if config is None:
                membership.close()
                raise RuntimeError(
                    f"no config registered in the coordinator for "
                    f"{args.type}/{args.name}; give --configpath")
    server = None
    try:
        server = JubatusServer(args, config=config)
        if (membership is not None and args.routing == "partition"
                and not hasattr(server.driver, "partition_ids")):
            raise ValueError(
                f"--routing partition supports the row-store engines "
                f"(recommender, nearest_neighbor, anomaly), not "
                f"{args.type!r}")
        # crash recovery BEFORE anything can route to us: snapshot
        # restore and journal replay run on the unstarted server
        recovery = server.init_durability()
        if args.model_file:
            # the file wins over recovered state; its load re-anchors the
            # journal, and the recovered MIX round is dropped with the
            # recovered model (the file's has no known round)
            server._recovered_round = 0
            server.load_file(args.model_file)
    except BaseException:
        if server is not None:
            server.stop()          # closes a journal recovery opened
        if membership is not None:
            membership.close()
        raise
    if membership is not None:
        server.membership = membership
        retry = None
        if ns.rpc_retry_max > 1:
            retry = RetryPolicy(max_attempts=ns.rpc_retry_max,
                                base_backoff=ns.rpc_retry_backoff_ms / 1e3)
        server.mixer = create_mixer(
            args.mixer, server, membership, interval_sec=args.interval_sec,
            interval_count=args.interval_count,
            rpc_timeout=args.interconnect_timeout, retry=retry,
            breaker_threshold=ns.breaker_threshold,
            breaker_cooldown=ns.breaker_cooldown,
            quantize=args.mix_quantize)
        # what an admitted slot joins the cluster with, under its own
        # name (tenancy/registry.py join_slot_cluster)
        server.cluster_ctx = ClusterContext(
            ls=membership.ls, mixer_kind=args.mixer,
            interval_sec=args.interval_sec,
            interval_count=args.interval_count,
            rpc_timeout=args.interconnect_timeout, retry=retry,
            breaker_threshold=ns.breaker_threshold,
            breaker_cooldown=ns.breaker_cooldown,
            quantize=args.mix_quantize, routing=args.routing,
            partition_interval=args.partition_handoff_interval_sec,
            partition_batch=args.partition_handoff_batch,
            partition_grace=args.partition_handoff_grace_sec)
        if (recovery is not None and not args.model_file
                and hasattr(server.mixer, "round")):
            # resume at the recovered round: the first scatter that
            # out-rounds us marks us behind, and the catch-up heals the
            # rounds we slept through
            server.mixer.round = max(server.mixer.round, recovery.round)
        _resume_collective(server, recovery, args)
    elif hasattr(server.driver, "device_mix"):
        # a standalone DP server: every MIX round is the collective fold
        # of its replicas on the card, on the count/tick trigger
        from jubatus_tpu_torch.mix.collective import CollectiveMixer
        server.mixer = CollectiveMixer(server,
                                       interval_sec=args.interval_sec,
                                       interval_count=args.interval_count)
        args.mix_collective = True   # the resolved tier, in get_status
        _resume_collective(server, recovery, args)
        server.mixer.start()
    rpc = RpcServer(threads=args.thread,
                    inline_raw=args.dispatch == "inline")
    bind_service(server, rpc)
    try:
        port = rpc.start(args.rpc_port, host=args.bind_address)
    except BaseException:
        server.stop()
        raise
    args.rpc_port = port  # with --rpc-port 0, server_id uses the bound port
    if args.metrics_port:
        from jubatus_tpu_torch.obs.exporter import MetricsExporter
        server.metrics_exporter = MetricsExporter(
            collect=server.metrics_snapshot, ident=server.server_id,
            host=args.bind_address)
        server.metrics_exporter.start(max(args.metrics_port, 0))
    if membership is not None:
        # recovered local state converges through MIX; a bootstrap would
        # discard its acked updates, and a --model_file load is the
        # operator's model
        recovered = recovery is not None and (recovery.restored
                                              or recovery.replayed > 0)
        try:
            _join_cluster(server, membership, port,
                          bootstrap=not recovered and not args.model_file)
        except BaseException:
            rpc.stop()
            server.stop()
            raise
    log.info("jubatus_tpu_torch %s server listening on %s:%d (device %s)",
             args.type, args.bind_address, port, server.driver.device)
    return server, rpc


def _resume_collective(server: JubatusServer, recovery, args) -> None:
    """Resume the journaled collective epoch ("cmix" records) after
    recovery, unless --model_file replaced the recovered model."""
    if (recovery is not None and not args.model_file
            and hasattr(server.mixer, "collective_round")):
        server.mixer.collective_round = max(server.mixer.collective_round,
                                            recovery.collective_round)


def _join_cluster(server: JubatusServer, membership, port: int,
                  bootstrap: bool = True) -> None:
    """A fresh joiner (`bootstrap`) pulls the model from a random live
    member before it becomes routable; then the server registers as an
    actor and an active member and starts its mixer thread."""
    peers = [p for p in membership.get_all_nodes() if p != (server.ip, port)]
    if bootstrap and peers:
        peer = random.choice(peers)
        try:
            if server.mixer.bootstrap(
                    server, peer[0], peer[1],
                    timeout=server.args.interconnect_timeout):
                log.info("bootstrapped model from %s:%d", *peer)
        except MixProtocolMismatch:
            raise                  # fatal, as in the JAX server
        except Exception as e:  # noqa: BLE001 - the peer may be gone
            log.warning("bootstrap from %s:%d failed: %s; starting empty",
                        peer[0], peer[1], e)
    # the CHT ring before the actor registration: once a proxy or a peer
    # can route here, replicating handlers (anomaly's add) must see it
    from jubatus_tpu_torch.cluster.cht import CHT
    cht = CHT(membership.ls, server.args.type, server.args.name)
    cht.register_node(server.ip, port)
    server.cht = cht
    if server.args.routing == "partition":
        # ownership: MIX must never re-replicate a row across partitions,
        # and rows out of this server's range hand off through the journal
        from jubatus_tpu_torch.framework.partition import PartitionManager
        manager = PartitionManager(
            server, interval=server.args.partition_handoff_interval_sec,
            batch=server.args.partition_handoff_batch,
            grace=server.args.partition_handoff_grace_sec)
        server.partition_manager = manager
        server.driver.partition_owned = manager.owns
        manager.start()
    membership.register_actor(server.ip, port)
    server.mixer.start()
    server.mixer.register_active(server.ip, port)
    # the slots restored from the catalog join THEIR MIX groups and rings
    # now that the session and the bound port exist
    server.slots.join_cluster_all()


def main(argv: Optional[Sequence[str]] = None) -> int:
    from jubatus_tpu_torch.utils import logger, signals
    ns = _parser().parse_args(argv)
    logger.configure(logfile=ns.logfile or None, level=ns.loglevel,
                     fmt=ns.log_format)
    signals.set_action_on_hup(logger.reopen)
    # before the server exists, so boot work (recovery) is traced too
    TRACER.configure(ring=ns.trace_ring, slow_op_ms=ns.slow_op_ms)
    if resolve_dispatch(ns.dispatch) == "threaded":
        # short GIL hand-offs between the RPC, convert and dispatch
        # threads (the JAX server's setting; inline keeps the default)
        sys.setswitchinterval(0.0005)
    server, rpc = serve(argv)
    if ns.torch_profile:
        from jubatus_tpu_torch.utils.metrics import start_profiler
        start_profiler(ns.torch_profile)
        log.info("torch profiler recording, written to %s on SIGTERM",
                 ns.torch_profile)
    stop = threading.Event()
    signals.set_action_on_term(stop.set)
    mp = server.metrics_exporter.port if server.metrics_exporter else 0
    print(f"jubatus ready rpc_port={server.args.rpc_port} metrics_port={mp} "
          f"state=ready", flush=True)
    stop.wait()
    rpc.stop()
    server.stop()
    if ns.torch_profile:
        from jubatus_tpu_torch.utils.metrics import stop_profiler
        log.info("torch profiler trace written to %s", stop_profiler())
    return 0


if __name__ == "__main__":
    sys.exit(main())
