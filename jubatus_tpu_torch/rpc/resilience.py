"""Retries with deadline budgets, and per-peer circuit breaking (the
port's copy of jubatus_tpu/rpc/resilience.py; same policies, same
counters).

RetryPolicy
    Bounded attempts with exponential backoff and full jitter
    (backoff = U[0, min(base * 2^i, cap)]), retrying only transport
    faults (RpcIOError / RpcTimeoutError), never RemoteError: an
    application error from a healthy peer would fail the same way on
    every attempt, and retrying an applied update would apply it twice.

Deadline budgets
    A retried call owns ONE time budget (the caller's timeout): each
    attempt's socket timeout is carved out of what remains, so retries
    never stack timeouts on top of the original.

PeerHealth
    Consecutive-failure circuit breaker with half-open probe
    re-admission.  A peer that fails `fail_threshold` transport calls in
    a row is OPEN: fan-outs skip it until `cooldown` elapses, then
    exactly one probe call is admitted; success closes the breaker,
    failure re-arms the cooldown.  Transitions and skips are counted in
    the metrics registry (utils/metrics.py), which get_status reads.

Partial-failure policies (STRICT, QUORUM, BEST_EFFORT)
    How many members a proxy's broadcast or scatter READ needs before it
    serves the members that answered (framework/proxy.py); updates are
    always strict.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

Peer = Tuple[str, int]

# jitter never reaches model state, so its stream need not be seeded
_jitter = random.Random()


def _transport_errors() -> tuple:
    # lazy: rpc.client imports this module at its top
    from jubatus_tpu_torch.rpc.client import RpcIOError, RpcTimeoutError
    return (RpcIOError, RpcTimeoutError)


@dataclass(frozen=True)
class RetryPolicy:
    """Knobs for call_with_retry; immutable so one instance is shared by
    every connection of a mixer."""

    max_attempts: int = 3
    base_backoff: float = 0.05       # seconds; doubles per attempt
    max_backoff: float = 2.0
    # per-attempt socket-timeout ceiling; None = an even split of the
    # remaining budget over the attempts still available
    attempt_timeout: Optional[float] = None
    # exception types worth a retry; None = (RpcIOError, RpcTimeoutError)
    retry_on: Optional[Tuple[type, ...]] = None

    def backoff(self, attempt: int, u: float) -> float:
        """Full-jitter backoff before attempt `attempt + 1`; u ~ U[0,1)."""
        return min(self.base_backoff * (2 ** attempt), self.max_backoff) * u

    def slice_timeout(self, remaining: float, attempt: int) -> float:
        """The socket timeout attempt `attempt` (0-based) may spend."""
        left = max(self.max_attempts - attempt, 1)
        if self.attempt_timeout is not None:
            return max(min(self.attempt_timeout, remaining), 1e-3)
        return max(remaining / left, 1e-3)

    def classify(self, exc: BaseException) -> bool:
        """True if exc is worth another attempt."""
        kinds = self.retry_on if self.retry_on is not None \
            else _transport_errors()
        return isinstance(exc, kinds)


def call_with_retry(attempt: Callable[[float], Any],
                    policy: Optional[RetryPolicy],
                    budget: float,
                    label: str = "",
                    metrics=_metrics) -> Any:
    """Run `attempt(timeout)` under `policy` within one deadline budget:
    the TOTAL wall-clock the call may spend across attempts and backoffs."""
    if policy is None or policy.max_attempts <= 1:
        return attempt(budget)
    deadline = time.monotonic() + budget
    last: Optional[BaseException] = None
    for i in range(policy.max_attempts):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            return attempt(policy.slice_timeout(remaining, i))
        except BaseException as e:  # noqa: BLE001 - reclassified below
            if not policy.classify(e):
                raise
            last = e
            if i + 1 >= policy.max_attempts:
                break
            metrics.inc("rpc_retry_total")
            pause = min(policy.backoff(i, _jitter.random()),
                        max(deadline - time.monotonic(), 0.0))
            if pause > 0:
                time.sleep(pause)
    if last is not None:
        raise last
    from jubatus_tpu_torch.rpc.client import RpcTimeoutError
    raise RpcTimeoutError(f"deadline budget exhausted calling {label}", label)


class _PeerState:
    __slots__ = ("fails", "opened_at", "probing")

    def __init__(self):
        self.fails = 0
        self.opened_at: Optional[float] = None   # None = breaker CLOSED
        self.probing = False                      # half-open probe in flight


class PeerHealth:
    """Per-peer consecutive-failure circuit breaker, shared by every
    fan-out of one process's mixer or proxy."""

    def __init__(self, fail_threshold: int = 3, cooldown: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=_metrics):
        self.fail_threshold = max(int(fail_threshold), 1)
        self.cooldown = cooldown
        self._clock = clock
        self._metrics = metrics
        self._peers: Dict[Peer, _PeerState] = {}
        self._lock = threading.Lock()

    def _state(self, peer: Peer) -> _PeerState:
        key = (peer[0], int(peer[1]))
        st = self._peers.get(key)
        if st is None:
            st = self._peers[key] = _PeerState()
        return st

    def allow(self, peer: Peer) -> bool:
        """CLOSED peers pass.  An OPEN peer past its cooldown admits
        exactly one half-open probe; everyone else is told to skip."""
        with self._lock:
            st = self._state(peer)
            if st.opened_at is None:
                return True
            if st.probing:
                skip = True
            elif self._clock() - st.opened_at >= self.cooldown:
                st.probing = True
                skip = False
            else:
                skip = True
        self._metrics.inc("breaker_skip_total" if skip
                          else "breaker_probe_total")
        return not skip

    def is_open(self, peer: Peer) -> bool:
        with self._lock:
            st = self._peers.get((peer[0], int(peer[1])))
            return st is not None and st.opened_at is not None

    def record_success(self, peer: Peer) -> None:
        with self._lock:
            st = self._state(peer)
            was_open = st.opened_at is not None
            st.fails = 0
            st.opened_at = None
            st.probing = False
        if was_open:
            self._metrics.inc("breaker_close_total")

    def record_failure(self, peer: Peer) -> None:
        opened = False
        with self._lock:
            st = self._state(peer)
            st.fails += 1
            if st.opened_at is None:
                if st.fails >= self.fail_threshold:
                    st.opened_at = self._clock()
                    opened = True
            elif st.probing:
                # failed probe: re-arm the cooldown from now
                st.opened_at = self._clock()
                st.probing = False
        if opened:
            self._metrics.inc("breaker_open_total")

    def filter_live(self, peers: Sequence[Peer]
                    ) -> Tuple[List[Peer], List[Peer]]:
        """Partition peers into (admitted, skipped) through allow()."""
        admitted: List[Peer] = []
        skipped: List[Peer] = []
        for hp in peers:
            (admitted if self.allow(hp) else skipped).append(tuple(hp))
        return admitted, skipped

    def snapshot(self) -> Dict[str, str]:
        """Flattened breaker state for get_status."""
        with self._lock:
            open_peers = sorted(f"{h}:{p}" for (h, p), st in self._peers.items()
                                if st.opened_at is not None)
            tracked = len(self._peers)
        return {
            "breaker_tracked_peers": str(tracked),
            "breaker_open_count": str(len(open_peers)),
            "breaker_open_peers": ",".join(open_peers),
        }


# the policy of server-to-server (MIX) traffic; the proxy forwards its
# reads with a 2-attempt policy (framework/proxy.py)
DEFAULT_RETRY = RetryPolicy()

# the proxy's partial-failure policies of broadcast and scatter READS
# (updates are always strict)
STRICT = "strict"            # any member error fails the call
QUORUM = "quorum"            # a majority of the members must answer
BEST_EFFORT = "best_effort"  # any one answer is served, the shortfall logged
PARTIAL_FAILURE_POLICIES = (STRICT, QUORUM, BEST_EFFORT)
