"""Server entry point of the port.

    python -m jubatus_tpu_torch.cli.server \
        --type classifier|regression|nearest_neighbor|recommender|anomaly \
        --configpath CONFIG.json --rpc-port 9199 [--device cuda|cpu] \
        [--name CLUSTER --coordinator HOST:PORT [--mixer linear_mixer] \
         [--interval_sec 16 --interval_count 512] [--mix_quantize]] \
        [--journal DIR [--journal_fsync batch] [--journal_segment_bytes N] \
         [--snapshot_interval 60]] [--read_batch_window_us W] \
        [--index off|lsh_probe|ivf [--index_probes 4]] \
        [--routing replicate|partition [--partition_handoff_batch 256] \
         [--partition_handoff_interval 1] [--partition_handoff_grace 2]]

Model state lives on --device: cuda (the default) or cpu; asking for cuda
on a machine without it fails at startup.  With --coordinator the
process joins the cluster <type>/<name>: it reads its config from the
coordinator when --configpath is absent, takes ids from the coordinator,
pulls the model from a random live member if there is one, registers
its CHT ring points (anomaly's add writes an id's two owners), an actor
and an active member, and starts its mixer thread, which mixes
every --interval_count updates or --interval_sec seconds (do_mix mixes
at once).  A coordinator it cannot reach fails the start, as does
--mixer collective_mixer (the data-parallel tier is not ported).

With --journal DIR the server recovers its model from DIR (the newest
valid snapshot, then the journal past it, replayed through the card's
kernels) before the RPC server is routable, journals every applied
update before acking it and snapshots in the background; a recovered
cluster member skips the joiner's bootstrap and resumes at the larger of
its mixer's and the recovered MIX round, healing missed rounds as a
straggler.  The JAX server's --model_file is not in the port yet.  With
--read_batch_window_us W > 0 concurrent classify (estimate) calls are
served as fused sweeps (framework/dispatch.py ReadDispatcher), and so
are concurrent nearest_neighbor *_from_datum reads.  --index lsh_probe
(the signature methods of nearest_neighbor, recommender and anomaly) or
ivf (the recommender's exact methods) serves the row engines' reads
through the sublinear candidate index (jubatus_tpu_torch/index/), probing
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

Like the JAX server's CLI it logs `... listening on host:port` and then
prints the machine-readable line `jubatus ready rpc_port=N metrics_port=0
state=ready` on stdout once it serves.  SIGTERM or SIGINT stops it.
"""

from __future__ import annotations

import argparse
import logging
import random
import signal
import sys
import threading
from typing import Optional, Sequence, Tuple

from jubatus_tpu_torch.framework.server_base import JubatusServer, ServerArgs
from jubatus_tpu_torch.framework.service import SERVICES, bind_service
from jubatus_tpu_torch.mix.linear_mixer import MixProtocolMismatch
from jubatus_tpu_torch.mix.mixer_factory import check_mixer, create_mixer
from jubatus_tpu_torch.rpc.server import RpcServer

log = logging.getLogger("jubatus_tpu_torch.server")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.cli.server")
    p.add_argument("--type", required=True, choices=sorted(SERVICES))
    p.add_argument("--rpc-port", type=int, default=9199)
    p.add_argument("--listen_addr", default="0.0.0.0")
    p.add_argument("--datadir", default="/tmp")
    p.add_argument("--configpath", default="",
                   help="engine config; with --coordinator it may be left "
                        "out and is read from the coordinator")
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
    p.add_argument("--mix_quantize", action="store_true",
                   help="ship MIX diff bodies as blockwise-int8 tensors + "
                        "f32 absmax scales (wire version 3); flip it "
                        "cluster-wide")
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
                        "builds no read lane")
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
    return p


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
    if not ns.configpath and not ns.coordinator:
        parser.error("--configpath is required without --coordinator")
    if ns.index_probes <= 0:
        parser.error("--index_probes must be > 0")
    args = ServerArgs(type=ns.type, name=ns.name, rpc_port=ns.rpc_port,
                      bind_address=ns.listen_addr, datadir=ns.datadir,
                      configpath=ns.configpath, eth=ns.eth, device=ns.device,
                      mixer=ns.mixer, interval_sec=ns.interval_sec,
                      interval_count=ns.interval_count,
                      coordinator=ns.coordinator,
                      interconnect_timeout=ns.interconnect_timeout,
                      mix_quantize=ns.mix_quantize, journal_dir=ns.journal,
                      journal_fsync=ns.journal_fsync,
                      journal_segment_bytes=ns.journal_segment_bytes,
                      snapshot_interval_sec=ns.snapshot_interval,
                      read_batch_window_us=ns.read_batch_window_us,
                      index=ns.index, index_probes=ns.index_probes,
                      routing=ns.routing,
                      partition_handoff_batch=ns.partition_handoff_batch,
                      partition_handoff_interval_sec=(
                          ns.partition_handoff_interval),
                      partition_handoff_grace_sec=ns.partition_handoff_grace)
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
    except BaseException:
        if server is not None:
            server.stop()          # closes a journal recovery opened
        if membership is not None:
            membership.close()
        raise
    if membership is not None:
        server.membership = membership
        server.mixer = create_mixer(
            args.mixer, server, membership, interval_sec=args.interval_sec,
            interval_count=args.interval_count,
            rpc_timeout=args.interconnect_timeout,
            quantize=args.mix_quantize)
        if recovery is not None and hasattr(server.mixer, "round"):
            # resume at the recovered round: the first scatter that
            # out-rounds us marks us behind, and the catch-up heals the
            # rounds we slept through
            server.mixer.round = max(server.mixer.round, recovery.round)
    rpc = RpcServer()
    bind_service(server, rpc)
    try:
        port = rpc.start(args.rpc_port, host=args.bind_address)
    except BaseException:
        server.stop()
        raise
    args.rpc_port = port  # with --rpc-port 0, server_id uses the bound port
    if membership is not None:
        # recovered local state converges through MIX; a bootstrap would
        # discard its acked updates
        recovered = recovery is not None and (recovery.restored
                                              or recovery.replayed > 0)
        try:
            _join_cluster(server, membership, port, bootstrap=not recovered)
        except BaseException:
            rpc.stop()
            server.stop()
            raise
    log.info("jubatus_tpu_torch %s server listening on %s:%d (device %s)",
             args.type, args.bind_address, port, server.driver.device)
    return server, rpc


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    server, rpc = serve(argv)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(f"jubatus ready rpc_port={server.args.rpc_port} metrics_port=0 "
          f"state=ready", flush=True)
    stop.wait()
    rpc.stop()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
