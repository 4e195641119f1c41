"""Consistent hash table over the coordination service (the port's copy of
jubatus_tpu/cluster/cht.py, host only).

Each node registers NUM_VSERV = 8 virtual points under
`/jubatus/actors/<type>/<name>/cht/<md5(ip_port_i)>` with the payload
`ip_port`; find(key, n) hashes the key and walks the ring clockwise,
collecting the first n distinct owners.  The ring lives in the
coordinator, so a node is routable exactly while its ephemeral points
live, and a JAX server and a port server in one cluster put each key on
the same owners.  Ring reads are cached by the listing's cversion.

The partition plane (framework/partition.py) reads the ring three more
ways: find_cached (no coordinator round trip, safe under the model write
lock), version (the ring's cversion, refreshing the cache) and arcs_for
(a node's virtual points).  A dropped model slot withdraws its node from
its ring (unregister_node).  The ring's other readers (belongs_to, nodes)
come with their caller, burst (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import List, Tuple

from jubatus_tpu_torch.cluster.lock_service import (
    CachedMembership, LockServiceBase, create_or_replace_ephemeral)
from jubatus_tpu_torch.cluster.membership import (ACTOR_BASE, build_loc_str,
                                                  revert_loc_str)

log = logging.getLogger("jubatus_tpu_torch.cht")

NUM_VSERV = 8  # virtual points a node


def make_hash(key: str) -> str:
    return hashlib.md5(key.encode()).hexdigest()


def cht_dir(engine_type: str, name: str) -> str:
    return f"{ACTOR_BASE}/{engine_type}/{name}/cht"


class CHT:
    def __init__(self, ls: LockServiceBase, engine_type: str, name: str,
                 cache_ttl: float = 1.0):
        self.ls = ls
        self.dir = cht_dir(engine_type, name)
        self._cache = CachedMembership(ls, self.dir, ttl=cache_ttl)
        self._lock = threading.Lock()
        self._ring: List[Tuple[str, Tuple[str, int]]] = []  # (hash, node)
        self._ring_version = -3

    def register_node(self, ip: str, port: int) -> None:
        loc = build_loc_str(ip, port)
        for i in range(NUM_VSERV):
            path = f"{self.dir}/{make_hash(f'{loc}_{i}')}"
            if not create_or_replace_ephemeral(self.ls, path, loc.encode()):
                raise RuntimeError(f"cannot register cht point {path}")

    def unregister_node(self, ip: str, port: int) -> None:
        """Explicit withdrawal of this node's virtual points (a dropped
        model slot): they are ephemerals of the still-alive process
        session, so without this the dropped slot's ring would route here
        until the process dies."""
        loc = build_loc_str(ip, port)
        for i in range(NUM_VSERV):
            self.ls.remove(f"{self.dir}/{make_hash(f'{loc}_{i}')}")

    def _refresh(self, force: bool = False
                 ) -> List[Tuple[str, Tuple[str, int]]]:
        hashes, ver = self._cache.members_versioned(force=force)
        with self._lock:
            if ver == self._ring_version:
                return self._ring
            ring = []
            for h in sorted(hashes):
                raw = self.ls.get(f"{self.dir}/{h}")
                if raw is None:
                    continue
                try:
                    loc = revert_loc_str(raw.decode())
                except (UnicodeDecodeError, ValueError):
                    # one garbled point must not poison every lookup
                    log.warning("skipping undecodable cht ring point %s "
                                "(%r)", h, raw)
                    continue
                ring.append((h, loc))
            self._ring = ring
            self._ring_version = ver
            return self._ring

    @staticmethod
    def _walk(ring: List[Tuple[str, Tuple[str, int]]], key: str,
              n: int) -> List[Tuple[str, int]]:
        """The first n distinct nodes clockwise from hash(key)."""
        if not ring:
            return []
        h = make_hash(key)
        start = 0
        for i, (vh, _) in enumerate(ring):
            if vh >= h:
                start = i
                break
        out: List[Tuple[str, int]] = []
        for i in range(len(ring)):
            node = ring[(start + i) % len(ring)][1]
            if node not in out:
                out.append(node)
                if len(out) >= n:
                    break
        return out

    def find(self, key: str, n: int = 2) -> List[Tuple[str, int]]:
        return self._walk(self._refresh(), key, n)

    def find_cached(self, key: str, n: int = 1) -> List[Tuple[str, int]]:
        """find() over the last refreshed ring, with no coordinator round
        trip: the ownership check made under the model write lock (the
        partition plane's put_diff filter).  The partition manager
        refreshes the ring from its own thread (version())."""
        with self._lock:
            ring = list(self._ring)
        return self._walk(ring, key, n)

    def version(self) -> int:
        """The ring's version (the coordinator's cversion of the cht
        directory).  Refreshes the cached ring, so find_cached sees a
        changed version at once."""
        self._refresh()
        with self._lock:
            return self._ring_version

    def arcs_for(self, ip: str, port: int) -> List[str]:
        """The virtual-point hashes of (ip, port): the ends of its arcs of
        the ring (get_status's partition_range)."""
        loc = (ip, port)
        with self._lock:
            return [h for h, node in self._ring if node == loc]
