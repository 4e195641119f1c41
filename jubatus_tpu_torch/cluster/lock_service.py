"""lock_service: the coordination client (the port's copy of
jubatus_tpu/cluster/lock_service.py).

Two backends of one interface (create / set / get / exists / remove,
ephemeral and sequence nodes, list, ids, locks):

  * StandaloneLockService: an in-process tree, for runs without a
    coordinator and for tests;
  * CoordLockService: an RPC client of a coordinator (the port's or the
    JAX package's; both speak the same RPCs) with a heartbeat thread that
    keeps its session, and with it every ephemeral node, alive.

Locks are sequence-node elections: create an ephemeral sequence node
under the lock path; you hold the lock iff yours is the lowest.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from jubatus_tpu_torch.rpc.client import (Client, RemoteError, RpcError,
                                          RpcTypeError)
from jubatus_tpu_torch.utils import to_bytes


def _str(x) -> str:
    return x.decode() if isinstance(x, bytes) else x


class LockServiceBase:
    def create(self, path: str, data: bytes = b"", ephemeral: bool = False) -> bool:
        raise NotImplementedError

    def create_seq(self, path: str, data: bytes = b"") -> Optional[str]:
        raise NotImplementedError

    def set(self, path: str, data: bytes) -> bool:
        raise NotImplementedError

    def get(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def remove(self, path: str) -> bool:
        raise NotImplementedError

    def list(self, path: str) -> List[str]:
        raise NotImplementedError

    def list_versioned(self, path: str) -> Tuple[List[str], int]:
        return self.list(path), -1

    def create_id(self, key: str) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def lock(self, path: str) -> "SeqLock":
        return SeqLock(self, path)


def create_or_replace_ephemeral(ls: LockServiceBase, path: str,
                                data: bytes = b"") -> bool:
    """Register an ephemeral node, replacing a stale one that a crashed
    predecessor on the same address left until its session expires."""
    if ls.create(path, data, ephemeral=True):
        return True
    ls.remove(path)
    return ls.create(path, data, ephemeral=True)


class SeqLock:
    """Ephemeral-sequence-node election lock."""

    def __init__(self, ls: LockServiceBase, path: str):
        self.ls = ls
        self.path = path
        self.my_node: Optional[str] = None

    def try_lock(self) -> bool:
        if self.my_node is None:
            self.my_node = self.ls.create_seq(self.path + "/lock-")
            if self.my_node is None:
                return False
        children = sorted(self.ls.list(self.path))
        if children and self.my_node.rsplit("/", 1)[-1] == children[0]:
            return True
        # lost: withdraw our node at once, or it would block every later
        # round (non-blocking try semantics)
        self.unlock()
        return False

    def still_held(self) -> bool:
        """Whether our election marker still exists.  A coordinator
        failover may reap it, and a second node may then win while we
        believe we hold the lock, so the holder re-checks at round
        boundaries.  The fence is refreshed first, so a stale primary
        cannot answer from its stale tree."""
        if self.my_node is None:
            return False
        refresh = getattr(self.ls, "refresh_epoch", None)
        if refresh is not None:
            refresh()
        return self.ls.exists(self.my_node)

    def unlock(self) -> None:
        if self.my_node is not None:
            self.ls.remove(self.my_node)
            self.my_node = None


class StandaloneLockService(LockServiceBase):
    """In-process tree; ephemerals vanish with the process."""

    def __init__(self):
        from jubatus_tpu_torch.cluster.coordinator import CoordinatorState
        self._state = CoordinatorState(session_ttl=1e9)
        self._sid, _ = self._state.open_session()

    def create(self, path, data=b"", ephemeral=False):
        return self._state.create(path, data, self._sid if ephemeral else None,
                                  False) is not None

    def create_seq(self, path, data=b""):
        return self._state.create(path, data, self._sid, True)

    def set(self, path, data):
        return self._state.set(path, data)

    def get(self, path):
        out = self._state.get(path)
        return None if out is None else to_bytes(out[0])

    def exists(self, path):
        return self._state.exists(path)

    def remove(self, path):
        return self._state.delete(path)

    def list(self, path):
        return list(self._state.list(path)[0])

    def list_versioned(self, path):
        names, ver = self._state.list(path)
        return list(names), int(ver)

    def create_id(self, key):
        return self._state.create_id(key)


class CoordLockService(LockServiceBase):
    """RPC client of a coordinator, or of a primary/standby pair.

    `coordinator` is a multi-address connect string ("h1:2181,h2:2182"):
    on an IO error or a `not_primary` / `fenced` / `no_quorum` refusal
    the client rotates to the next address and retries until `retry_for`
    seconds elapse.  If the primary no longer knows our session
    (`session_expired`), the heartbeat reopens one and re-creates every
    ephemeral node this client registered.  Every call carries our
    highest observed primary epoch as its trailing fence argument.
    """

    def __init__(self, coordinator: str, timeout: float = 10.0,
                 retry_for: float = 20.0):
        self._addrs = []
        for part in coordinator.split(","):
            part = part.strip()
            if part:
                host, port = part.rsplit(":", 1)
                self._addrs.append((host, int(port)))
        if not self._addrs:
            raise ValueError("empty coordinator address string")
        self._idx = 0
        self.timeout = timeout
        self.retry_for = retry_for
        self._client = Client(self._addrs[0][0], self._addrs[0][1],
                              timeout=timeout)
        # re-entrant: a session reset re-registers from inside the call path
        self._rpc_lock = threading.RLock()
        self._ephemerals: Dict[str, bytes] = {}   # path -> data (ours)
        self._reset_pending = False               # re-registration owed
        self._verify_pending = False              # ephemeral audit owed
        self._epoch = 0                           # highest epoch seen
        self._epoch_stale = False                 # refresh owed (rotation)
        self._epoch_checked = -1e9                # refresh_epoch cache stamp
        sid, ttl, *ep = self._call("open_session")
        self._sid: str = _str(sid)
        self._ttl = float(ttl)
        if ep:
            self._epoch = max(self._epoch, int(ep[0]))
        self._stop = threading.Event()
        # heartbeats paced to the ttl the coordinator reports
        self._hb = threading.Thread(target=self._heartbeat, daemon=True,
                                    args=(max(self._ttl / 3, 0.2),),
                                    name="coord-heartbeat")
        self._hb.start()

    def _rotate(self) -> None:
        self._client.close()
        self._idx = (self._idx + 1) % len(self._addrs)
        host, port = self._addrs[self._idx]
        self._client = Client(host, port, timeout=self.timeout)
        # after a failover an ephemeral of ours may be missing on the new
        # primary while our session survived: the next heartbeat audits
        self._verify_pending = True
        self._epoch_stale = True

    def _call(self, method, *args):
        with self._rpc_lock:
            deadline = time.monotonic() + self.retry_for
            while True:
                try:
                    return self._client.call_raw(method, *args)
                except RemoteError as e:
                    # the primary is elsewhere: a standby, a fenced stale
                    # primary, or a quorum primary without its majority
                    if ("not_primary" not in str(e)
                            and "fenced" not in str(e)
                            and "no_quorum" not in str(e)):
                        raise
                    last = e
                except RpcError as e:
                    last = e     # node down / timeout: try the next one
                if time.monotonic() > deadline:
                    raise last
                self._rotate()
                time.sleep(min(0.1, self.retry_for / 10))

    def _mcall(self, method, *args):
        """Call with our fence as the optional trailing argument."""
        try:
            return self._call(method, *args, self._epoch)
        except RemoteError as e:
            # a coordinator without fencing refuses the extra argument
            # before the handler runs, so a fence-less retry is safe
            if not isinstance(e, RpcTypeError) \
                    and "positional argument" not in str(e):
                raise
            return self._call(method, *args)

    def refresh_epoch(self, max_age: float = 2.0) -> int:
        """The highest primary epoch reachable now: role() on every
        address in parallel with a short timeout; cached for max_age s."""
        now = time.monotonic()
        if now - self._epoch_checked < max_age:
            return self._epoch

        def probe(addr):
            host, port = addr
            try:
                with Client(host, port,
                            timeout=min(1.5, self.timeout)) as pr:
                    return int(pr.call_raw("role")[2])
            except Exception:  # noqa: BLE001 - unreachable: best effort
                return -1

        if len(self._addrs) == 1:
            epochs = [probe(self._addrs[0])]
        else:
            with ThreadPoolExecutor(len(self._addrs)) as pool:
                epochs = list(pool.map(probe, self._addrs))
        self._epoch = max(self._epoch, *epochs)
        self._epoch_checked = time.monotonic()
        self._epoch_stale = False
        return self._epoch

    def _reset_session(self) -> None:
        with self._rpc_lock:
            # stays set until re-registration completes, so a failure
            # part way is retried by the next heartbeat
            self._reset_pending = True
            sid, ttl, *ep = self._mcall("open_session")
            self._sid = _str(sid)
            self._ttl = float(ttl)
            if ep:
                self._epoch = max(self._epoch, int(ep[0]))
            for path, data in list(self._ephemerals.items()):
                if self._mcall("create", path, data, self._sid, False) is None:
                    self._mcall("delete", path)
                    self._mcall("create", path, data, self._sid, False)
            self._reset_pending = False
            self._verify_pending = False

    def _verify_ephemerals(self) -> None:
        """Re-create any ephemeral of ours the primary is missing.  Runs
        under _rpc_lock."""
        for path, data in list(self._ephemerals.items()):
            if not bool(self._mcall("exists", path)):
                self._mcall("create", path, data, self._sid, False)
        self._verify_pending = False

    def _heartbeat(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                if self._epoch_stale:
                    self.refresh_epoch(max_age=0.0)
                if (self._mcall("ping", self._sid) is False
                        or self._reset_pending):
                    self._reset_session()
                elif self._verify_pending:
                    with self._rpc_lock:
                        self._verify_ephemerals()
            except Exception:  # noqa: BLE001 - the next beat retries
                pass

    def create(self, path, data=b"", ephemeral=False):
        if not ephemeral:
            return self._mcall("create", path, data, "", False) is not None
        with self._rpc_lock:
            try:
                out = self._mcall("create", path, data, self._sid, False)
            except RemoteError as e:
                if "session_expired" not in str(e):
                    raise
                self._reset_session()
                out = self._mcall("create", path, data, self._sid, False)
            if out is not None:
                self._ephemerals[path] = to_bytes(data)
            return out is not None

    def create_seq(self, path, data=b""):
        with self._rpc_lock:
            try:
                out = self._mcall("create", path, data, self._sid, True)
            except RemoteError as e:
                if "session_expired" not in str(e):
                    raise
                self._reset_session()
                out = self._mcall("create", path, data, self._sid, True)
        return None if out is None else _str(out)

    def set(self, path, data):
        with self._rpc_lock:
            out = self._mcall("set", path, data)
            if out and path in self._ephemerals:
                # a later re-registration replays the latest data
                self._ephemerals[path] = to_bytes(data)
            return out

    def get(self, path):
        out = self._mcall("get", path)
        return None if out is None else to_bytes(out[0])

    def exists(self, path):
        return bool(self._mcall("exists", path))

    def remove(self, path):
        with self._rpc_lock:
            out = bool(self._mcall("delete", path))
            # untracked only once the delete ran
            self._ephemerals.pop(path, None)
            return out

    def list(self, path):
        return [_str(x) for x in self._mcall("list", path)[0]]

    def list_versioned(self, path):
        names, ver = self._mcall("list", path)
        return [_str(x) for x in names], int(ver)

    def create_id(self, key):
        return int(self._mcall("create_id", key))

    def close(self):
        self._stop.set()
        self.retry_for = 1.0   # teardown must not spin the full window
        try:
            self._mcall("close_session", self._sid)
        except Exception:  # noqa: BLE001 - the session expires anyway
            pass
        self._client.close()


class CachedMembership:
    """Read-through membership cache, invalidated by cversion polling."""

    def __init__(self, ls: LockServiceBase, path: str, ttl: float = 1.0):
        self.ls = ls
        self.path = path
        self.ttl = ttl
        self._cache: List[str] = []
        self._version = -2
        self._checked = 0.0
        self._lock = threading.Lock()

    def members(self, force: bool = False) -> List[str]:
        return self.members_versioned(force=force)[0]

    def members_versioned(self, force: bool = False) -> Tuple[List[str], int]:
        """-> (names, cversion)."""
        with self._lock:
            now = time.monotonic()
            if force or now - self._checked >= self.ttl:
                names, ver = self.ls.list_versioned(self.path)
                self._checked = now
                if ver != self._version:
                    self._cache = names
                    self._version = ver
            return list(self._cache), self._version


def create_lock_service(kind: str, coordinator: str = "") -> LockServiceBase:
    if kind in ("standalone", "local", ""):
        return StandaloneLockService()
    if kind in ("coordinator", "coord", "rpc"):
        if not coordinator:
            raise ValueError("coordinator address required")
        return CoordLockService(coordinator)
    raise ValueError(f"unknown lock service kind: {kind}")
