"""Synchronous msgpack-RPC client and fan-out multi-client (the port's
copy of jubatus_tpu/rpc/client.py).

Every service call carries the cluster `name` as argument 0 (`call`);
mixer-internal and coordinator RPCs go without it (`call_raw`).  MClient
issues one call to N hosts at once and collects per-host results and
errors.

A Client given a RetryPolicy (rpc/resilience.py) treats its `timeout`
as the call's whole deadline budget: each attempt's socket timeout is
carved out of what remains, transport faults (RpcIOError,
RpcTimeoutError) are retried with full-jitter backoff, and RemoteError
never is.  MClient also takes a PeerHealth breaker: OPEN peers are
skipped without a connect or a timeout, and every leg feeds the breaker.
The JAX client's fault-injection and lock-order hooks are later work.
"""

from __future__ import annotations

import logging
import socket
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import msgpack

from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _lock_monitor
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

log = logging.getLogger("jubatus_tpu_torch.rpc.client")

REQUEST = 0
RESPONSE = 1


class RpcError(RuntimeError):
    """Base of the typed client errors; each carries the failing method.

    `request_sent` is False when the failure provably came before the
    request was delivered (connect refused), so a re-send cannot apply
    it twice; the default True means "the peer may have processed it"."""

    request_sent = True

    def __init__(self, msg: str = "", method: str = ""):
        super().__init__(msg)
        self.method = method


class RpcIOError(RpcError):
    """Connect or transport failure."""


class RpcTimeoutError(RpcError):
    """Call deadline exceeded."""


class RpcNoResult(RpcError):
    """Broken or undecodable response stream."""


class RemoteError(RpcError):
    """The server answered with an error value (a string or an
    msgpack-rpc error code)."""

    def __init__(self, error: Any, method: str = ""):
        super().__init__(str(error), method)
        self.error = error


class RpcMethodNotFound(RemoteError):
    """Server error code 1."""


class RpcTypeError(RemoteError):
    """Server error code 2: argument arity or type mismatch."""


class RpcCallError(RemoteError):
    """Application error raised inside the handler."""


# the errors a breaker counts and a RetryPolicy may retry
TRANSPORT_ERRORS = (RpcIOError, RpcTimeoutError, RpcNoResult)

# imported after the taxonomy exists: resilience resolves its default
# retry_on classes from this module
from jubatus_tpu_torch.rpc.resilience import (  # noqa: E402
    PeerHealth, RetryPolicy, call_with_retry)


def _mark_sent(err: RpcError, sent: bool) -> RpcError:
    err.request_sent = sent
    return err


def _remote_error(error: Any, method: str) -> RemoteError:
    """Map a wire error value to its typed class."""
    if error == 1:
        return RpcMethodNotFound(error, method)
    if error == 2:
        return RpcTypeError(error, method)
    return RpcCallError(error, method)


def _unpacker() -> msgpack.Unpacker:
    return msgpack.Unpacker(raw=False, strict_map_key=False,
                            unicode_errors="surrogateescape",
                            max_buffer_size=1 << 30)


class Client:
    def __init__(self, host: str, port: int, name: str = "",
                 timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = None):
        self.host = host
        self.port = port
        self.name = name
        self.timeout = timeout
        self.retry = retry
        self._sock: Optional[socket.socket] = None
        self._unpacker = _unpacker()
        self._msgid = 0

    def _connect(self, timeout: float) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=timeout)
        else:
            self._sock.settimeout(timeout)
        return self._sock

    def settimeout(self, timeout: float) -> None:
        """Set the call budget, a live socket's too (the proxy shrinks a
        pooled connection's to what a routing deadline has left)."""
        self.timeout = timeout
        if self._sock is not None:
            self._sock.settimeout(timeout)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._unpacker = _unpacker()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def call_raw(self, method: str, *params: Any) -> Any:
        """Call without the cluster name.  With a RetryPolicy, `timeout`
        is the whole deadline budget; without one the single attempt gets
        all of it."""
        if self.retry is None:
            return self._call_once(method, params, self.timeout)
        return call_with_retry(
            lambda t: self._call_once(method, params, t),
            self.retry, budget=self.timeout, label=method)

    def _call_once(self, method: str, params: Tuple[Any, ...],
                   timeout: float) -> Any:
        # a synchronous wire round trip: the lock-order detector flags a
        # caller still holding the model write lock (--debug_locks)
        if _lock_monitor.enabled:
            _lock_monitor.note_blocking(f"rpc.{method}")
        self._msgid += 1
        msgid = self._msgid
        sent = False
        try:
            sock = self._connect(timeout)
            sock.sendall(msgpack.packb([REQUEST, msgid, method, list(params)],
                                       use_bin_type=True,
                                       unicode_errors="surrogateescape"))
            sent = True
            while True:
                try:
                    for msg in self._unpacker:
                        if msg[0] == RESPONSE and msg[1] == msgid:
                            _, _, error, result = msg
                            if error is not None:
                                raise _remote_error(error, method)
                            return result
                except msgpack.UnpackException as e:
                    self.close()
                    raise _mark_sent(RpcNoResult(
                        f"broken response stream on {method}: {e}",
                        method), sent) from e
                data = sock.recv(1 << 16)
                if not data:
                    self.close()
                    raise _mark_sent(
                        RpcIOError("connection closed by peer", method), sent)
                self._unpacker.feed(data)
        except socket.timeout as e:
            self.close()
            raise _mark_sent(RpcTimeoutError(f"rpc timeout calling {method}",
                                             method), sent) from e
        except (ConnectionError, OSError) as e:
            self.close()
            raise _mark_sent(RpcIOError(f"rpc io error calling {method}: {e}",
                                        method), sent) from e

    def call(self, method: str, *params: Any) -> Any:
        """Service call: the cluster name is argument 0."""
        return self.call_raw(method, self.name, *params)


Peer = Tuple[str, int]


class MClient:
    """One call fanned out to N hosts at once; a dead host costs one
    timeout in all, and with a PeerHealth breaker a known-dead host costs
    nothing (it is reported in the errors as circuit-open)."""

    def __init__(self, hosts: Sequence[Peer], timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = None,
                 health: Optional[PeerHealth] = None):
        self.hosts = list(hosts)
        self.timeout = timeout
        self.retry = retry
        self.health = health

    def call_each(self, method: str, *params: Any,
                  observer: Optional[Callable] = None
                  ) -> Tuple[List[Tuple[Peer, Any]], Dict[Peer, str]]:
        """-> ([(host, result)] of the successes in HOST-LIST order, the
        fold order MIX depends on; {host: error} of the failures).
        `observer(host, seconds, exc_or_None)` is called once for every
        ATTEMPTED host with the leg's wall time (the MIX legs' records);
        breaker-skipped hosts are not observed."""
        by_host: Dict[Peer, Any] = {}
        errors: Dict[Peer, str] = {}
        for hp, result, err in self.call_each_iter(method, *params,
                                                   observer=observer):
            if err is None:
                by_host[hp] = result
            else:
                errors[hp] = err
        paired = [(hp, by_host.pop(hp)) for hp in map(tuple, self.hosts)
                  if hp in by_host]
        return paired, errors

    def call_each_iter(self, method: str, *params: Any,
                       observer: Optional[Callable] = None):
        """Yields (host, result, error_or_None) in COMPLETION order, one
        per host, as each leg lands: the pipelined MIX gather decodes and
        folds diff N while diff N+1 is still in flight.  Breaker-skipped
        hosts yield their circuit-open error first."""

        def one(hp: Peer):
            t0 = time.monotonic() if observer is not None else 0.0
            err: Optional[BaseException] = None
            try:
                return self._call_one_host(hp, method, params)
            except BaseException as e:  # noqa: BLE001 - relayed via future
                err = e
                raise
            finally:
                if observer is not None:
                    try:
                        observer(hp, time.monotonic() - t0, err)
                    except Exception as oe:  # noqa: BLE001 - never fail
                        # the fan-out for an observer, never silently
                        _metrics.inc_keyed("rpc_swallowed_error_total",
                                           "observer")
                        log.debug("fan-out observer failed: %s", oe,
                                  exc_info=True)

        if not self.hosts:
            return
        if self.health is not None:
            attempt, skipped = self.health.filter_live(self.hosts)
            for hp in skipped:
                yield hp, None, "circuit open (skipped, no timeout burned)"
        else:
            attempt = [tuple(hp) for hp in self.hosts]
        if not attempt:
            return
        with ThreadPoolExecutor(max_workers=min(len(attempt), 32)) as pool:
            futures = {pool.submit(one, tuple(hp)): tuple(hp)
                       for hp in attempt}
            for fut in as_completed(futures):
                hp = futures[fut]
                try:
                    yield hp, fut.result(), None
                except Exception as e:  # noqa: BLE001 - reported per host
                    yield hp, None, str(e)

    def _call_one_host(self, hp: Peer, method: str,
                       params: Tuple[Any, ...]) -> Any:
        """One host's leg: transport faults count against the peer;
        anything that produced a response (RemoteError too) counts as
        alive."""
        host, port = hp
        try:
            with Client(host, port, timeout=self.timeout,
                        retry=self.retry) as c:
                result = c.call_raw(method, *params)
        except TRANSPORT_ERRORS:
            if self.health is not None:
                self.health.record_failure(hp)
            raise
        except Exception:
            if self.health is not None:
                self.health.record_success(hp)
            raise
        if self.health is not None:
            self.health.record_success(hp)
        return result
