"""Server entry point of the port.

    python -m jubatus_tpu_torch.cli.server --type classifier|regression \
        --configpath CONFIG.json --rpc-port 9199 [--device cuda|cpu]

Model state lives on --device: cuda (the default) or cpu; asking for cuda
on a machine without it fails at startup.  Like the JAX server's CLI it
logs `... listening on host:port` and then prints the machine-readable
line `jubatus ready rpc_port=N metrics_port=0 state=ready` on stdout once
it serves.  SIGTERM or SIGINT stops it.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from typing import Optional, Sequence, Tuple

from jubatus_tpu_torch.framework.server_base import JubatusServer, ServerArgs
from jubatus_tpu_torch.framework.service import SERVICES, bind_service
from jubatus_tpu_torch.rpc.server import RpcServer


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.cli.server")
    p.add_argument("--type", required=True, choices=sorted(SERVICES))
    p.add_argument("--rpc-port", type=int, default=9199)
    p.add_argument("--listen_addr", default="0.0.0.0")
    p.add_argument("--datadir", default="/tmp")
    p.add_argument("--configpath", required=True)
    p.add_argument("--name", default="")
    p.add_argument("--eth", default="", help="advertised address override")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where model state and kernels run")
    return p


def serve(argv: Optional[Sequence[str]] = None
          ) -> Tuple[JubatusServer, RpcServer]:
    """Build the server and start answering RPCs on a background thread;
    returns (server, rpc).  rpc.stop() and then server.stop() end it."""
    ns = _parser().parse_args(argv)
    args = ServerArgs(type=ns.type, name=ns.name, rpc_port=ns.rpc_port,
                      bind_address=ns.listen_addr, datadir=ns.datadir,
                      configpath=ns.configpath, eth=ns.eth, device=ns.device)
    server = JubatusServer(args)
    rpc = RpcServer()
    bind_service(server, rpc)
    try:
        port = rpc.start(args.rpc_port, host=args.bind_address)
    except BaseException:
        server.stop()
        raise
    args.rpc_port = port  # with --rpc-port 0, server_id uses the bound port
    logging.info("jubatus_tpu_torch %s server listening on %s:%d (device %s)",
                 args.type, args.bind_address, port, server.driver.device)
    return server, rpc


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
