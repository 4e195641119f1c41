"""jubacoordinator, single node (the port's copy of
jubatus_tpu/cluster/coordinator.py without its standby, snapshots and
quorum ensemble).

The coordination service's data model, served over the port's
msgpack-RPC server:

  * hierarchical nodes with bytes payloads and per-node versions
  * ephemeral nodes bound to a SESSION: clients heartbeat with ping();
    a session that misses its TTL is reaped with its ephemerals
  * sequence nodes (create with seq=True appends a monotonically
    increasing 10-digit suffix, the election-lock building block)
  * watches by polling: each mutation bumps the parent's cversion, and
    "list" returns (children, cversion)
  * the epoch handshake: open_session answers [sid, ttl, epoch], and
    every client-facing op takes one optional trailing epoch (the
    caller's fence).  The JAX CoordLockService sends it on every call, so
    without it a JAX client would fail here with an arity error.  A fence
    above our epoch comes from a caller that has seen another, newer
    primary: the call is refused with the typed `fenced` error.  With no
    standby of its own to hand over to, this node stays primary for
    every other caller (the JAX coordinator demotes itself instead).

It serves the RPCs that CoordLockService calls: open_session, ping,
close_session, create, set, get, exists, delete, list, create_id and
role.  The warm standby (sync_state, promotion), the disk snapshots and
the quorum ensemble are later work.

Run: python -m jubatus_tpu_torch.cluster.coordinator --rpc-port 2181 \
         [--listen_addr 0.0.0.0] [--session_ttl 10]
It prints `jubacoordinator (primary) listening on HOST:PORT` once it
serves; SIGTERM or SIGINT stops it.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.utils import to_bytes

DEFAULT_SESSION_TTL = 10.0

# RPC error strings with protocol meaning (clients match on these):
SESSION_EXPIRED_ERROR = "session_expired"  # sid unknown; reopen + re-register
FENCED_ERROR = "fenced"                    # a caller saw a higher epoch

log = logging.getLogger("jubatus_tpu_torch.coordinator")


class _Node:
    __slots__ = ("data", "version", "cversion", "children", "ephemeral_owner",
                 "seq_counter")

    def __init__(self, data: bytes = b""):
        self.data = data
        self.version = 0
        self.cversion = 0
        self.children: Dict[str, _Node] = {}
        self.ephemeral_owner: Optional[str] = None
        self.seq_counter = 0


class CoordinatorState:
    def __init__(self, session_ttl: float = DEFAULT_SESSION_TTL,
                 clock=time.monotonic):
        self.root = _Node()
        self.lock = threading.RLock()
        self.sessions: Dict[str, float] = {}      # session_id -> last ping
        self.session_ttl = session_ttl
        self.clock = clock                        # tests step it
        # the primary generation (fence); only a standby's promotion
        # raises it in the JAX package, so here it stays 1
        self.epoch = 1
        self.id_counters: Dict[str, int] = {}
        self.mutations = 0                        # reported by role()

    def _mark(self) -> None:
        self.mutations += 1

    # -- path helpers -------------------------------------------------------

    def _walk(self, path: str, create: bool = False) -> Optional[_Node]:
        node = self.root
        for part in [p for p in path.split("/") if p]:
            child = node.children.get(part)
            if child is None:
                if not create:
                    return None
                child = _Node()
                node.children[part] = child
                node.cversion += 1
            node = child
        return node

    def _parent_of(self, path: str) -> Tuple[Optional[_Node], str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            return None, ""
        node = self.root
        for part in parts[:-1]:
            child = node.children.get(part)
            if child is None:
                return None, parts[-1]
            node = child
        return node, parts[-1]

    # -- sessions -------------------------------------------------------------

    def open_session(self):
        """-> [session_id, ttl_seconds]; clients pace heartbeats to ttl/3."""
        with self.lock:
            sid = uuid.uuid4().hex
            self.sessions[sid] = self.clock()
            self._mark()
            return [sid, self.session_ttl]

    def ping(self, sid: str) -> bool:
        with self.lock:
            if sid not in self.sessions:
                return False
            self.sessions[sid] = self.clock()
            return True

    def close_session(self, sid: str) -> bool:
        with self.lock:
            self.sessions.pop(sid, None)
            self._reap_ephemerals({sid})
            self._mark()
            return True

    def reap_expired(self) -> List[str]:
        with self.lock:
            now = self.clock()
            dead = {s for s, t in self.sessions.items()
                    if now - t > self.session_ttl}
            for s in dead:
                del self.sessions[s]
            if dead:
                self._reap_ephemerals(dead)
                self._mark()
            return sorted(dead)

    def _reap_ephemerals(self, dead: set) -> None:
        def walk(node: _Node):
            doomed = []
            for name, child in node.children.items():
                walk(child)
                if child.ephemeral_owner in dead:
                    doomed.append(name)
            for name in doomed:
                del node.children[name]
                node.cversion += 1
        walk(self.root)

    # -- node ops -------------------------------------------------------------

    def create(self, path: str, data: bytes, ephemeral_session: Optional[str],
               seq: bool) -> Optional[str]:
        with self.lock:
            if ephemeral_session and ephemeral_session not in self.sessions:
                # the owning session is gone: the node would be orphaned,
                # so the client reopens a session and re-registers
                raise RuntimeError(SESSION_EXPIRED_ERROR)
            parent, name = self._parent_of(path)
            if parent is None:
                # intermediate directories are created on the way
                parts = [p for p in path.split("/") if p]
                self._walk("/" + "/".join(parts[:-1]), create=True)
                parent, name = self._parent_of(path)
                assert parent is not None
            if seq:
                parent.seq_counter += 1
                name = f"{name}{parent.seq_counter:010d}"
            elif name in parent.children:
                return None  # already exists
            node = _Node(bytes(data))
            node.ephemeral_owner = ephemeral_session
            parent.children[name] = node
            parent.cversion += 1
            self._mark()
            return path if not seq else path + f"{parent.seq_counter:010d}"

    def set(self, path: str, data: bytes) -> bool:
        with self.lock:
            node = self._walk(path, create=True)
            node.data = bytes(data)
            node.version += 1
            self._mark()
            return True

    def get(self, path: str):
        with self.lock:
            node = self._walk(path)
            if node is None:
                return None
            return [node.data, node.version]

    def exists(self, path: str) -> bool:
        with self.lock:
            return self._walk(path) is not None

    def delete(self, path: str) -> bool:
        with self.lock:
            parent, name = self._parent_of(path)
            if parent is None or name not in parent.children:
                return False
            del parent.children[name]
            parent.cversion += 1
            self._mark()
            return True

    def list(self, path: str):
        """-> [sorted children names, cversion]"""
        with self.lock:
            node = self._walk(path)
            if node is None:
                return [[], -1]
            return [sorted(node.children), node.cversion]

    def create_id(self, key: str) -> int:
        """Cluster-unique sequence per key (1, 2, 3, ...)."""
        with self.lock:
            n = self.id_counters.get(key, 0) + 1
            self.id_counters[key] = n
            self._mark()
            return n


def _s(x) -> str:
    return x.decode() if isinstance(x, bytes) else (x or "")


def _b(x) -> bytes:
    return b"" if x is None else to_bytes(x)


class CoordinatorServer:
    def __init__(self, session_ttl: float = DEFAULT_SESSION_TTL):
        self.state = CoordinatorState(session_ttl)
        self.rpc = RpcServer()
        s = self.state
        guard = self._guard
        self.rpc.add("open_session",
                     guard(lambda: s.open_session() + [s.epoch],
                           fenced_arity=0))
        self.rpc.add("ping", guard(lambda sid: s.ping(_s(sid)),
                                   fenced_arity=1))
        self.rpc.add("close_session",
                     guard(lambda sid: s.close_session(_s(sid)),
                           fenced_arity=1))
        self.rpc.add("create", guard(lambda path, data, eph_sid, seq:
                     s.create(_s(path), _b(data), _s(eph_sid) or None,
                              bool(seq)), fenced_arity=4))
        self.rpc.add("set", guard(lambda path, data: s.set(_s(path), _b(data)),
                                  fenced_arity=2))
        self.rpc.add("get", guard(lambda path: s.get(_s(path)),
                                  fenced_arity=1))
        self.rpc.add("exists", guard(lambda path: s.exists(_s(path)),
                                     fenced_arity=1))
        self.rpc.add("delete", guard(lambda path: s.delete(_s(path)),
                                     fenced_arity=1))
        self.rpc.add("list", guard(lambda path: s.list(_s(path)),
                                   fenced_arity=1))
        self.rpc.add("create_id", guard(lambda key: s.create_id(_s(key)),
                                        fenced_arity=1))
        self.rpc.add("role", lambda: ["primary", s.mutations, s.epoch])
        self._reaper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _check_fence(self, fence) -> None:
        """A caller showing a HIGHER epoch has talked to a newer primary
        elsewhere: refuse its call with the typed error, so its client
        rotates on.  Role and epoch stay as they are."""
        if fence is not None and int(fence) > self.state.epoch:
            log.error("fenced: caller observed epoch %d > ours %d",
                      int(fence), self.state.epoch)
            raise RuntimeError(FENCED_ERROR)

    def _guard(self, fn, fenced_arity: int):
        # an op takes one OPTIONAL trailing argument beyond its arity: the
        # caller's observed epoch, checked first
        def wrapped(*args):
            if len(args) > fenced_arity:
                self._check_fence(args[fenced_arity])
                args = args[:fenced_arity]
            return fn(*args)
        return wrapped

    def start(self, port: int, host: str = "0.0.0.0") -> int:
        bound = self.rpc.start(port, host)

        def reap_loop():
            while not self._stop.wait(self.state.session_ttl / 4):
                self.state.reap_expired()

        self._reaper = threading.Thread(target=reap_loop, daemon=True,
                                        name="coord-reaper")
        self._reaper.start()
        return bound

    def stop(self) -> None:
        self._stop.set()
        self.rpc.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jubatus_tpu_torch.cluster.coordinator",
        description="coordination service (single node)")
    p.add_argument("--rpc-port", type=int, default=2181)
    p.add_argument("--listen_addr", default="0.0.0.0")
    p.add_argument("--session_ttl", type=float, default=DEFAULT_SESSION_TTL)
    ns = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    srv = CoordinatorServer(session_ttl=ns.session_ttl)
    port = srv.start(ns.rpc_port, ns.listen_addr)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(f"jubacoordinator (primary) listening on "
          f"{ns.listen_addr}:{port}", flush=True)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
