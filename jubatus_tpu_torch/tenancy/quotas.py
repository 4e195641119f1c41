"""Per-tenant quotas: admission limits and token-bucket rate control (the
port's copy of jubatus_tpu/tenancy/quotas.py, host code).

  QuotaSpec      one slot's limit set (max rows, train/query rps) that a
                 create_model request carries, or the host's --quota_*
                 defaults when it carries none
  TokenBucket    continuous-refill rate limiter (monotonic clock,
                 thread-safe, burst = one second of rate)
  TenantQuotas   the server's authority: buckets keyed by tenant, shared
                 by every slot the tenant owns (a tenant with three models
                 still gets one train budget), and the per-tenant slot cap
                 create_model consults
  ProxyQuotaGate the proxy's early rejector: a TTL-cached tenancy view
                 (fetched through the list_models RPC) drives local token
                 buckets, so over-quota traffic dies at the edge without a
                 forward; the server's check stays authoritative

Every rejection counts `tenant_quota_rejected_total.<tenant>` in the
process metrics registry.  The JAX package also flags its health surface
(quota_saturated); the health plane is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

TRAIN = "train"
QUERY = "query"


class QuotaExceeded(RuntimeError):
    """Admission rejected; reaches the client as the RPC error string,
    prefixed so a client can match it without parsing prose.  The RPC
    server logs it without a stack (an expected refusal)."""

    log_trace = False

    def __init__(self, tenant: str, what: str):
        super().__init__(f"quota_exceeded: tenant {tenant!r} {what}")
        self.tenant = tenant


def _reject(tenant: str) -> None:
    # the capped family: tenant names are operator input and must stay
    # bounded (utils/metrics.py DYNAMIC_SERIES_CAP)
    _metrics.inc_keyed("tenant_quota_rejected_total", tenant or "default")


@dataclass
class QuotaSpec:
    """One slot's limit set; 0 is unlimited on that axis (the default: a
    slot with no quota costs one `is None` check a request)."""

    max_rows: int = 0          # resident rows across the tenant's slots
    train_rps: float = 0.0     # token-bucket rate on train/update RPCs
    query_rps: float = 0.0     # token-bucket rate on read RPCs

    @classmethod
    def from_wire(cls, obj: Any) -> Optional["QuotaSpec"]:
        """Decode the create_model quota map (None or {}: no quota)."""
        if not obj:
            return None
        if not isinstance(obj, dict):
            raise ValueError(f"quota must be a map, got {type(obj).__name__}")

        def _num(key, cast):
            v = obj.get(key, obj.get(key.encode(), 0))
            return cast(v or 0)
        spec = cls(max_rows=_num("max_rows", int),
                   train_rps=_num("train_rps", float),
                   query_rps=_num("query_rps", float))
        return spec if (spec.max_rows or spec.train_rps or spec.query_rps) \
            else None

    def to_wire(self) -> Dict[str, Any]:
        return {"max_rows": self.max_rows, "train_rps": self.train_rps,
                "query_rps": self.query_rps}


class TokenBucket:
    """Continuous-refill token bucket: capacity max(rate, 1) tokens (one
    second of burst), refilled on every take() from the monotonic clock;
    rate <= 0 always admits.  A charge above the capacity (a coalesced
    burst wider than one second of rate) is admitted once the bucket is
    full and drives it negative, a deficit later refills pay off."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._tokens = max(self.rate, 1.0)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def set_rate(self, rate: float) -> None:
        """Re-rate in place, keeping the token level (clamped to the new
        capacity): a fresh bucket a rate flip would hand out a full burst
        each time traffic alternates two differently-rated models of one
        tenant."""
        with self._lock:
            now = time.monotonic()
            if self.rate > 0:
                self._tokens = min(max(self.rate, 1.0),
                                   self._tokens
                                   + (now - self._last) * self.rate)
            self._last = now
            self.rate = float(rate)
            self._tokens = min(self._tokens, max(self.rate, 1.0))

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            cap = max(self.rate, 1.0)
            self._tokens = min(cap, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= min(n, cap):
                self._tokens -= n        # may go negative: burst deficit
                return True
            return False


class TenantQuotas:
    """The server's per-tenant budgets.  Buckets are keyed (tenant, kind)
    and shared by the tenant's slots; a tenant's rate is the latest
    non-zero rate one of its slots declared."""

    def __init__(self, max_slots: int = 0):
        self.max_slots = int(max_slots)     # per-tenant slot cap (0: off)
        self._buckets: Dict[tuple, TokenBucket] = {}
        self._lock = threading.Lock()

    def configure(self, tenant: str, spec: Optional[QuotaSpec]) -> None:
        """Install or update the tenant's buckets from one slot's spec.  A
        zero rate never clears a bucket (a second slot with only a row cap
        must not lift the tenant's rate limit); a different non-zero rate
        re-rates it in place."""
        if spec is None:
            return
        with self._lock:
            for kind, rate in ((TRAIN, spec.train_rps),
                               (QUERY, spec.query_rps)):
                if rate <= 0:
                    continue
                key = (tenant, kind)
                have = self._buckets.get(key)
                if have is None:
                    self._buckets[key] = TokenBucket(rate)
                elif have.rate != rate:
                    have.set_rate(rate)

    def forget(self, tenant: str, still_used: bool) -> None:
        """Drop a tenant's buckets once its last slot is gone (a later
        slot starts with a full burst, like a new tenant)."""
        if still_used:
            return
        with self._lock:
            for kind in (TRAIN, QUERY):
                self._buckets.pop((tenant, kind), None)

    def allow(self, tenant: str, kind: str, n: float = 1.0) -> None:
        """Raise QuotaExceeded when the tenant's `kind` bucket is dry; a
        tenant with no bucket always passes."""
        bucket = self._buckets.get((tenant, kind))
        if bucket is not None and not bucket.take(n):
            _reject(tenant)
            raise QuotaExceeded(tenant, f"{kind} rate limit "
                                        f"({bucket.rate:g}/s) exceeded")

    def check_slot_count(self, tenant: str, current: int) -> None:
        if self.max_slots and current >= self.max_slots:
            _reject(tenant)
            raise QuotaExceeded(
                tenant, f"slot limit reached ({current}/{self.max_slots})")

    def check_rows(self, tenant: str, rows: int, limit: int) -> None:
        if limit and rows >= limit:
            _reject(tenant)
            raise QuotaExceeded(tenant, f"row limit reached "
                                        f"({rows}/{limit})")


@dataclass
class _TenancyView:
    """One fetched list_models answer at the proxy."""
    models: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    fetched: float = 0.0


class ProxyQuotaGate:
    """The proxy's early admission: reject over-quota tenants before any
    forward.  The (model -> tenant, quota) view comes from the cluster's
    list_models RPC, refreshed in the background on TTL expiry (`submit`
    is an executor's submit; None refreshes inline), so the request path
    reads only the cached view and a sick member never adds its timeout
    to a forward.  An unknown model (a single-model cluster, a view not
    fetched yet) passes; the server's check stays authoritative."""

    def __init__(self, fetch: Callable[[str], Dict[str, Dict[str, Any]]],
                 submit: Optional[Callable] = None, ttl: float = 2.0):
        self._fetch = fetch          # fetch(cluster_name) -> models map
        self._submit = submit
        self.ttl = float(ttl)
        self._views: Dict[str, _TenancyView] = {}
        self._refreshing: Dict[str, bool] = {}
        self._buckets: Dict[tuple, TokenBucket] = {}
        self._lock = threading.Lock()

    def _refresh(self, name: str) -> None:
        try:
            models = self._fetch(name) or {}
        except Exception:  # noqa: BLE001 - keep the stale view
            # a membership hiccup must never fail requests: serve the
            # stale view (or none) and retry at the next expiry
            with self._lock:
                view = self._views.get(name)
                models = view.models if view is not None else {}
        with self._lock:
            self._views[name] = _TenancyView(models=models,
                                             fetched=time.monotonic())
            self._refreshing[name] = False

    def _view(self, name: str) -> _TenancyView:
        now = time.monotonic()
        with self._lock:
            view = self._views.get(name)
            fresh = view is not None and now - view.fetched < self.ttl
            kick = not fresh and not self._refreshing.get(name)
            if kick:
                self._refreshing[name] = True
        if kick:
            if self._submit is not None:
                self._submit(self._refresh, name)
            else:
                self._refresh(name)
                with self._lock:
                    view = self._views.get(name)
        return view if view is not None else _TenancyView()

    def _bucket(self, tenant: str, kind: str, rate: float) -> TokenBucket:
        key = (tenant, kind)
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = TokenBucket(rate)
                self._buckets[key] = b
            elif b.rate != rate:
                b.set_rate(rate)
            return b

    def info_of(self, model: str) -> Optional[Dict[str, Any]]:
        """The cached {tenant, quota, ...} entry of a model (None when
        unknown)."""
        return self._view(model).models.get(model)

    def admit(self, model: str, kind: str) -> None:
        """Called with a forward's wire model name (argument 0); raises
        QuotaExceeded on a dry bucket."""
        info = self.info_of(model)
        if not info:
            return
        quota = info.get("quota") or {}
        rate = float(quota.get("train_rps" if kind == TRAIN
                               else "query_rps", 0) or 0)
        if rate <= 0:
            return
        tenant = str(info.get("tenant", ""))
        if not self._bucket(tenant, kind, rate).take():
            _reject(tenant)
            raise QuotaExceeded(tenant, f"{kind} rate limit ({rate:g}/s) "
                                        "exceeded (proxy)")
