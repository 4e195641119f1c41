"""Proxy entry point of the port (the juba<engine>_proxy).

    python -m jubatus_tpu_torch.cli.proxy \
        --type nearest_neighbor|recommender|anomaly|classifier|regression \
        --coordinator HOST:PORT [--rpc-port 9199] [--listen_addr 0.0.0.0] \
        [--routing replicate|partition] \
        [--partial_failure strict|quorum|best_effort] \
        [--thread 4] [--timeout 10] [--session_pool_expire 60] \
        [--rpc_retry_max 2] [--rpc_retry_backoff_ms 50] \
        [--breaker_threshold 3] [--breaker_cooldown 5] [--eth ADDR] \
        [--query_cache_entries N] [--query_cache_bytes B] \
        [--trace_ring N] [--slow_op_ms MS] [--metrics_port P] \
        [--loglevel info] [--log_format plain|json]

It routes every client request to the servers of the cluster <type>/<name>
that the request names (framework/proxy.py); with --routing partition
(set it on every server and proxy of the cluster) point ops go to the
key's one ring owner and top-k reads scatter-gather.  A model slot of
the servers (create_model) is a cluster of its own name, routed the
same way; create_model and drop_model reach every member, list_models
merges theirs, and the tenant quota gate refuses an over-rate tenant's
call before it is forwarded.  The proxy holds no model and touches no
card.  --query_cache_* turn on its epoch-keyed read
cache, --trace_ring / --slow_op_ms its tracer (get_proxy_traces), and
--metrics_port its exporter (/metrics, /metrics.json, /traces.json,
/livez; negative: an ephemeral port).  Like the JAX proxy's CLI it logs
`... proxy listening on host:port` and then prints `jubatus ready
rpc_port=N metrics_port=M state=ready` on stdout; SIGTERM or SIGINT
stops it.

The JAX proxy's autopilot flags (ROADMAP Queue 1 item 7) are accepted at
their defaults and refused otherwise, naming the item.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from typing import Optional, Sequence, Tuple

from jubatus_tpu_torch.framework.proxy import Proxy, later_refusal
from jubatus_tpu_torch.framework.service import SERVICES
from jubatus_tpu_torch.obs.trace import TRACER
from jubatus_tpu_torch.rpc.resilience import (PARTIAL_FAILURE_POLICIES,
                                              RetryPolicy)
from jubatus_tpu_torch.utils import logger

# (flag, its argparse keywords, the ROADMAP Queue 1 item that brings it)
LATER_FLAGS = (
    ("--autopilot", {"action": "store_true"}, "7"),
    ("--autopilot_placement", {"type": int, "default": 1}, "7"),
    ("--autopilot_shed", {"type": int, "default": 1}, "7"),
    ("--autopilot_shed_burn_threshold", {"type": float, "default": 2.0},
     "7"),
    ("--autopilot_shed_floor", {"type": float, "default": 0.25}, "7"),
    ("--autopilot_dry_run", {"action": "store_true"}, "7"),
)


def make_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.cli.proxy")
    p.add_argument("--type", required=True, choices=sorted(SERVICES))
    p.add_argument("--coordinator", required=True,
                   help="host:port of the coordination service")
    p.add_argument("--rpc-port", type=int, default=9199)
    p.add_argument("--listen_addr", default="0.0.0.0")
    p.add_argument("--thread", type=int, default=4,
                   help="requests served at once")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="deadline budget of a forwarded call, retries "
                        "included")
    p.add_argument("--session_pool_expire", type=float, default=60.0,
                   help="seconds an idle forward connection is kept")
    p.add_argument("--routing", default="replicate",
                   choices=("replicate", "partition"),
                   help="'partition' makes the CHT row ownership for the "
                        "row engines: point ops go to the key's one ring "
                        "owner, top-k reads (similar_row, neighbor_row, "
                        "calc_score) scatter to every partition and the "
                        "proxy merges the partial top-ks.  Set it "
                        "cluster-wide with the servers' --routing "
                        "partition.  'replicate' (default) keeps the "
                        "reference behaviour")
    p.add_argument("--partial_failure", default="strict",
                   choices=PARTIAL_FAILURE_POLICIES,
                   help="broadcast and scatter READS: strict fails on any "
                        "member error (the reference); quorum serves a "
                        "majority; best_effort serves whoever answered.  "
                        "Updates are always strict")
    p.add_argument("--rpc_retry_max", type=int, default=2,
                   help="attempts a READ forward (transport faults only; "
                        "<= 1 disables retries; updates never retry)")
    p.add_argument("--rpc_retry_backoff_ms", type=float, default=50.0,
                   help="base full-jitter backoff between retries")
    p.add_argument("--breaker_threshold", type=int, default=3,
                   help="consecutive transport failures before a "
                        "member's circuit opens")
    p.add_argument("--breaker_cooldown", type=float, default=5.0,
                   help="seconds an open circuit waits before one "
                        "half-open probe call")
    p.add_argument("--eth", default="", help="advertised address override")
    p.add_argument("--query_cache_entries", type=int, default=0,
                   help="max entries of the epoch-keyed cache of CHT-routed, "
                        "broadcast and partition-scatter reads (keyed on "
                        "the target set; the epoch bumps on every "
                        "mutating forward through THIS proxy and on a "
                        "ring change); 0 with --query_cache_bytes 0: off")
    p.add_argument("--query_cache_bytes", type=int, default=0,
                   help="max total bytes of cached encoded answers (0: "
                        "unbounded on this axis)")
    p.add_argument("--trace_ring", type=int, default=0,
                   help="finished spans kept in the ring (proxy.forward "
                        "and proxy.partition_merge records, the "
                        "requests' rpc.* spans; get_proxy_traces and "
                        "/traces.json); 0 (default): no spans")
    p.add_argument("--slow_op_ms", type=float, default=0.0,
                   help="log one structured line a proxied request slower "
                        "than this many ms; 0 (default): off")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="serve /metrics, /metrics.json, /traces.json and "
                        "/livez over HTTP on this port (get_proxy_status "
                        "reports it); 0 (default): off; negative: an "
                        "ephemeral port")
    p.add_argument("--log_format", default="plain", choices=("plain", "json"),
                   help="'json': one JSON object a log record, with the "
                        "active trace and span ids")
    p.add_argument("--loglevel", default="info")
    for flag, kw, item in LATER_FLAGS:
        p.add_argument(flag, help=later_refusal(flag, item) + "; only "
                       "the default is accepted", **kw)
    return p


def build(argv: Optional[Sequence[str]] = None
          ) -> Tuple[Proxy, argparse.Namespace]:
    """Parse the flags and build the proxy (not started)."""
    parser = make_argparser()
    ns = parser.parse_args(argv)
    for flag, kw, item in LATER_FLAGS:
        if getattr(ns, flag[2:]) != kw.get("default", False):
            parser.error(later_refusal(flag, item))
    retry = None
    if ns.rpc_retry_max > 1:
        retry = RetryPolicy(max_attempts=ns.rpc_retry_max,
                            base_backoff=ns.rpc_retry_backoff_ms / 1000.0)
    return Proxy(ns.coordinator, ns.type, timeout=ns.timeout,
                 threads=ns.thread,
                 session_pool_expire=ns.session_pool_expire,
                 partial_failure=ns.partial_failure, retry=retry,
                 breaker_threshold=ns.breaker_threshold,
                 breaker_cooldown=ns.breaker_cooldown,
                 routing=ns.routing,
                 query_cache_entries=ns.query_cache_entries,
                 query_cache_bytes=ns.query_cache_bytes), ns


def main(argv: Optional[Sequence[str]] = None) -> int:
    proxy, ns = build(argv)
    logger.configure(level=ns.loglevel, fmt=ns.log_format)
    TRACER.configure(ring=ns.trace_ring, slow_op_ms=ns.slow_op_ms)
    # the advertised address: --eth, else the listen address (a wildcard
    # listen advertises loopback), as the port's server does
    ip = ns.eth or (ns.listen_addr if ns.listen_addr not in ("", "0.0.0.0")
                    else "127.0.0.1")
    port = proxy.start(ns.rpc_port, host=ns.listen_addr, advertised_ip=ip)
    if ns.metrics_port:
        from jubatus_tpu_torch.obs.exporter import MetricsExporter
        proxy.metrics_exporter = MetricsExporter(
            collect=proxy.metrics_snapshot, ident=f"{ns.type}_proxy:{port}",
            host=ns.listen_addr)
        proxy.metrics_exporter.start(max(ns.metrics_port, 0))
    logging.info("jubatus_tpu_torch %s proxy listening on %s:%d",
                 ns.type, ns.listen_addr, port)
    mp = proxy.metrics_exporter.port if proxy.metrics_exporter else 0
    print(f"jubatus ready rpc_port={port} metrics_port={mp} state=ready",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
