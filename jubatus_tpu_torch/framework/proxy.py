"""Stateless request router, the jubaproxy (the port's copy of the core of
jubatus_tpu/framework/proxy.py, host only).

Every client-facing Method of the engine's service table
(framework/service.py) is registered under its routing: RANDOM forwards
to one live member, BROADCAST fans out to every member and CHT to the
key's ring owners, each join folded with the Method's aggregator.  With
`routing="partition"` (framework/partition.py) the ring is row
ownership: a CHT point op goes to the key's one owner, and a read that
carries a ScatterRead scatters to every member and merges the partial
top-ks (a from_id read first fetches its query payload from the id's
owner, falling back to the other members mid-handoff).

Partial failure (rpc/resilience.py): updates keep the reference's rule,
any member error fails the call; broadcast and scatter READS follow the
proxy's policy (`strict`, `quorum` serves a majority, `best_effort`
whoever answered, counted in proxy_degraded_total).  RANDOM routing
rotates to another member on a transport failure, steered by a PeerHealth
breaker shared with the fan-outs; reads retry under one deadline budget.
Forward connections come from a session pool with idle expiry, and a
pooled connection that died idle gets one reconnect.  The proxy registers
itself under /jubatus/jubaproxies.

The query cache (`query_cache_entries` / `query_cache_bytes`, off by
default) holds broadcast, CHT-routed and partition-scatter READS, keyed
on the target set and a per-cluster epoch that every mutating forward
through this proxy bumps, and any change of the CHT ring too
(_check_ring_epoch); a degraded partial-failure answer is served but
never cached.  With the tracer on, every attempted forward is one
`proxy.forward` record (peer, method, ok) and every partition merge one
`proxy.partition_merge` record (method, partitions, candidates).
get_metrics and get_traces broadcast to the members and merge;
get_proxy_metrics and get_proxy_traces answer the proxy's own.

Model slots (tenancy/): the wire name is a slot's name, and a slot joins
the cluster under it, so the per-name membership, ring, epoch and cache
key route slots with no more code.  create_model and drop_model
broadcast to every member of the named cluster as updates (strict: a
partial admission would fork the slot set) and list_models merges the
members' maps.  The quota gate (tenancy/quotas.py ProxyQuotaGate)
rejects an engine call over its tenant's rate before any forward, from a
tenancy view that list_models refreshes in the background; the members'
check stays authoritative.

Not in the port yet, refused with their ROADMAP Queue 1 item 7: a
create_model placement directive and the autopilot's shedding, and the
fleet and health snapshots (get_fleet_snapshot).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import jubatus_tpu_torch
from jubatus_tpu_torch.cluster.cht import CHT
from jubatus_tpu_torch.cluster.lock_service import (
    CachedMembership, CoordLockService, LockServiceBase,
    create_or_replace_ephemeral)
from jubatus_tpu_torch.cluster.membership import (
    PROXY_BASE, actor_node_dir, build_loc_str, decode_loc_strs)
from jubatus_tpu_torch.framework.partition import (ROUTING_MODES,
                                                   merge_anomaly_score,
                                                   merge_topk)
from jubatus_tpu_torch.framework.query_cache import (create_query_cache,
                                                     serve_cached)
from jubatus_tpu_torch.framework.service import (
    AGG_ADD, AGG_ALL_AND, AGG_ALL_OR, AGG_CONCAT, AGG_MERGE, AGG_PASS,
    BROADCAST, CHT as CHT_ROUTING, INTERNAL, RANDOM, SERVICES, Method)
from jubatus_tpu_torch.rpc.client import (
    Client, RemoteError, RpcError, RpcIOError, RpcTimeoutError,
    TRANSPORT_ERRORS)
from jubatus_tpu_torch.rpc.resilience import (
    PARTIAL_FAILURE_POLICIES, QUORUM, STRICT, PeerHealth, RetryPolicy,
    call_with_retry)
from jubatus_tpu_torch.obs.trace import TRACER as _tracer
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.tenancy.quotas import QUERY as _Q_QUERY
from jubatus_tpu_torch.tenancy.quotas import TRAIN as _Q_TRAIN
from jubatus_tpu_torch.tenancy.quotas import ProxyQuotaGate
from jubatus_tpu_torch.utils import to_str
from jubatus_tpu_torch.utils.metrics import GLOBAL as _metrics

log = logging.getLogger("jubatus_tpu_torch.proxy")

# the JAX proxy's RPCs of later items, each refused with its item
LATER_RPCS = {"get_fleet_snapshot": "7"}


def later_refusal(what: str, item: str) -> str:
    return f"{what} is not in the port yet: ROADMAP Queue 1 item {item}"


class SessionPool:
    """Reusable client connections keyed by (host, port), with idle
    expiry."""

    def __init__(self, timeout: float = 10.0, expire: float = 60.0,
                 max_per_host: int = 16):
        self.timeout = timeout
        self.expire = expire
        self.max_per_host = max_per_host
        self._idle: Dict[Tuple[str, int], List[Tuple[float, Client]]] = {}
        self._lock = threading.Lock()

    def checkout(self, host: str, port: int) -> Client:
        """An idle connection, else a fresh one.  `pooled` tells the
        caller that the socket sat idle here: it may have died with a
        restarted backend, so its first RpcIOError earns one reconnect (a
        fresh connection's error is news and fails at once)."""
        key = (host, port)
        now = time.monotonic()
        with self._lock:
            bucket = self._idle.get(key, [])
            while bucket:
                ts, client = bucket.pop()
                if now - ts < self.expire:
                    client.pooled = True
                    return client
                client.close()
        client = Client(host, port, timeout=self.timeout)
        client.pooled = False
        return client

    def checkin(self, client: Client) -> None:
        key = (client.host, client.port)
        client.settimeout(self.timeout)   # undo a per-call budget shrink
        with self._lock:
            bucket = self._idle.setdefault(key, [])
            if len(bucket) < self.max_per_host:
                bucket.append((time.monotonic(), client))
                return
        client.close()

    def discard(self, client: Client) -> None:
        client.close()

    def close(self) -> None:
        with self._lock:
            for bucket in self._idle.values():
                for _, c in bucket:
                    c.close()
            self._idle.clear()


def aggregate(kind: str, results: List[Any]) -> Any:
    """Fold broadcast or cht results (the reference's aggregators)."""
    if not results:
        raise RpcError("no results to aggregate")
    if kind == AGG_PASS:
        return results[0]
    if kind == AGG_ALL_AND:
        return all(bool(r) for r in results)
    if kind == AGG_ALL_OR:
        return any(bool(r) for r in results)
    if kind == AGG_CONCAT:
        out: List[Any] = []
        for r in results:
            out.extend(r or [])
        return out
    if kind == AGG_MERGE:
        merged: Dict[Any, Any] = {}
        for r in results:
            merged.update(r or {})
        return merged
    if kind == AGG_ADD:
        total = results[0]
        for r in results[1:]:
            total += r
        return total
    raise ValueError(f"unknown aggregator: {kind}")


class Proxy:
    def __init__(self, coordinator, engine_type: str,
                 timeout: float = 10.0, threads: int = 4,
                 session_pool_expire: float = 60.0,
                 membership_ttl: float = 1.0,
                 partial_failure: str = STRICT,
                 retry: Optional[RetryPolicy] = RetryPolicy(max_attempts=2),
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 5.0,
                 routing: str = "replicate",
                 query_cache_entries: int = 0,
                 query_cache_bytes: int = 0):
        if partial_failure not in PARTIAL_FAILURE_POLICIES:
            raise ValueError(f"unknown partial-failure policy "
                             f"{partial_failure!r} "
                             f"(have {PARTIAL_FAILURE_POLICIES})")
        if routing not in ROUTING_MODES:
            raise ValueError(f"unknown routing mode {routing!r} "
                             f"(have {ROUTING_MODES})")
        if engine_type not in SERVICES:
            raise ValueError(f"unknown engine type {engine_type!r} "
                             f"(have {sorted(SERVICES)})")
        self.routing = routing
        if isinstance(coordinator, LockServiceBase):
            self.ls: LockServiceBase = coordinator
            self._own_ls = False    # the caller's session: never closed here
        else:
            self.ls = CoordLockService(coordinator)
            self._own_ls = True
        self.engine_type = engine_type
        self.timeout = timeout
        self.partial_failure = partial_failure
        # retries apply to READ forwards only: an update re-sent may apply
        # twice (its recovery is RANDOM rotation and the pooled reconnect)
        self.retry = retry
        self.health = PeerHealth(fail_threshold=breaker_threshold,
                                 cooldown=breaker_cooldown)
        self.pool = SessionPool(timeout=timeout, expire=session_pool_expire)
        self.rpc = RpcServer(call_workers=threads)
        self._fanout = ThreadPoolExecutor(max_workers=32,
                                          thread_name_prefix="proxy-fanout")
        self._members: Dict[str, CachedMembership] = {}
        self._chts: Dict[str, CHT] = {}
        self._mlock = threading.Lock()
        self._ttl = membership_ttl
        self.start_time = time.time()
        self.ip = "127.0.0.1"
        self.port = 0
        # bumped from many handler and fan-out threads
        self._stat_lock = threading.Lock()
        self.request_count = 0
        self.forward_count = 0
        self._rng = random.Random()
        # the read cache, keyed also on the target set; the epoch is per
        # cluster name and bumps on every mutating forward THROUGH THIS
        # PROXY (an update through another proxy or a direct client
        # invalidates only at the next local one, which is why it is off
        # by default) and on every ring change (_check_ring_epoch)
        self.query_cache = create_query_cache(query_cache_entries,
                                              query_cache_bytes)
        self._epochs: Dict[str, int] = {}
        self._ring_versions: Dict[str, int] = {}
        self._epoch_lock = threading.Lock()
        # set by _scatter_results when a partial-failure policy served a
        # degraded answer; the read handler (per handler thread) then
        # vetoes the cache fill
        self._degraded = threading.local()
        # the HTTP exporter, started by the CLI with --metrics_port
        self.metrics_exporter = None
        # per-tenant early rejection at the edge: the (model -> tenant,
        # quota) view refreshes in the background through the cluster's
        # list_models, so the request path reads only the cached view
        self.quota_gate = ProxyQuotaGate(self._fetch_tenancy,
                                         submit=self._fanout.submit)
        self._register_all()

    def _fetch_tenancy(self, name: str) -> Dict[str, Any]:
        """One list_models fetch for the gate's background refresh."""
        return self._handle_random("list_models", name, (), update=False)

    # -- the cache's epochs ---------------------------------------------------

    def _epoch(self, name: str) -> int:
        with self._epoch_lock:
            return self._epochs.get(name, 0)

    def _bump_epoch(self, name: str) -> None:
        with self._epoch_lock:
            self._epochs[name] = self._epochs.get(name, 0) + 1

    def _check_ring_epoch(self, name: str) -> None:
        """Bump the cluster's epoch when its CHT ring changed.  The key's
        target set cannot see every change (a node re-registering at the
        same address, a re-shuffle that flips which of two owners is the
        primary, rows moving mid-handoff), so any ring change
        invalidates every cached read of the name."""
        ver = self._cht(name).version()
        with self._epoch_lock:
            known = self._ring_versions.get(name)
            if known is None:
                self._ring_versions[name] = ver
            elif known != ver:
                self._ring_versions[name] = ver
                self._epochs[name] = self._epochs.get(name, 0) + 1
                _metrics.inc("proxy_ring_epoch_bump_total")

    # -- membership ----------------------------------------------------------

    def _membership(self, name: str) -> CachedMembership:
        with self._mlock:
            m = self._members.get(name)
            if m is None:
                m = CachedMembership(
                    self.ls, actor_node_dir(self.engine_type, name),
                    ttl=self._ttl)
                self._members[name] = m
            return m

    def _cht(self, name: str) -> CHT:
        with self._mlock:
            c = self._chts.get(name)
            if c is None:
                c = CHT(self.ls, self.engine_type, name, cache_ttl=self._ttl)
                self._chts[name] = c
            return c

    def _get_members(self, name: str) -> List[Tuple[str, int]]:
        members = decode_loc_strs(self._membership(name).members(), "nodes")
        if not members:
            raise RpcError(f"no server found for {self.engine_type}/{name}")
        return members

    # -- forwarding ----------------------------------------------------------

    def _call_on(self, client: Client, host: str, port: int, method: str,
                 params: Tuple[Any, ...]) -> Any:
        """One forward on one connection, feeding the breaker: transport
        faults count against the peer, any answer (a RemoteError too)
        counts as alive."""
        try:
            result = client.call_raw(method, *params)
        except RemoteError:
            self.pool.checkin(client)
            self.health.record_success((host, port))
            raise
        except TRANSPORT_ERRORS:
            self.pool.discard(client)
            self.health.record_failure((host, port))
            raise
        except Exception:
            self.pool.discard(client)
            raise
        self.pool.checkin(client)
        self.health.record_success((host, port))
        return result

    def _forward_one(self, host: str, port: int, method: str,
                     params: Tuple[Any, ...],
                     timeout: Optional[float] = None,
                     update: bool = True) -> Any:
        """One `proxy.forward` record a forward attempt (peer, method,
        ok) with the tracer on; off, one attribute check."""
        if not _tracer.enabled:
            return self._forward_one_inner(host, port, method, params,
                                           timeout=timeout, update=update)
        t0 = time.monotonic()
        ok = False
        try:
            out = self._forward_one_inner(host, port, method, params,
                                          timeout=timeout, update=update)
            ok = True
            return out
        finally:
            _tracer.record("proxy.forward", time.monotonic() - t0,
                           peer=f"{host}:{port}", method=method, ok=ok)

    def _forward_one_inner(self, host: str, port: int, method: str,
                           params: Tuple[Any, ...],
                           timeout: Optional[float] = None,
                           update: bool = True) -> Any:
        """Forward through the session pool; `timeout` shrinks the
        connection's budget to a routing deadline's remainder.  A pooled
        connection's first RpcIOError earns one reconnect, for an update
        only while the failure provably came before delivery
        (request_sent False): past that the member may have applied it."""
        with self._stat_lock:
            self.forward_count += 1
        client = self.pool.checkout(host, port)
        if timeout is not None:
            client.settimeout(max(min(timeout, self.timeout), 1e-3))
        pooled = getattr(client, "pooled", False)
        try:
            return self._call_on(client, host, port, method, params)
        except RpcIOError as e:
            if not pooled or (update and e.request_sent):
                raise
            _metrics.inc("proxy_pool_reconnect_total")
            with self._stat_lock:
                self.forward_count += 1
            fresh = Client(host, port,
                           timeout=(timeout if timeout is not None
                                    else self.timeout))
            fresh.pooled = False
            return self._call_on(fresh, host, port, method, params)

    def _scatter_results(self, hosts: List[Tuple[str, int]], method: str,
                         params: Tuple[Any, ...], update: bool = True
                         ) -> List[Tuple[Tuple[str, int], Any]]:
        """Fan out at once and drain every future (an early failure must
        not leave calls in flight) -> the (member, result) pairs that
        answered, which the partition merge needs.  Updates fail on any
        member error; reads follow the partial-failure policy, skipping
        breaker-open members (which count as failed)."""
        policy = STRICT if update else self.partial_failure
        hosts = [tuple(hp) for hp in hosts]
        skipped: List[Tuple[str, int]] = []
        attempt = hosts
        if policy != STRICT:
            attempt, skipped = self.health.filter_live(hosts)
            if not attempt:
                # every breaker open: probing them all beats a certain
                # failure
                attempt, skipped = hosts, []
        retry = self.retry if not update else None

        def call_one(host: str, port: int) -> Any:
            if retry is not None:
                return call_with_retry(
                    lambda t: self._forward_one(host, port, method, params,
                                                timeout=t, update=update),
                    retry, budget=self.timeout, label=method)
            return self._forward_one(host, port, method, params,
                                     update=update)

        futures = [(hp, self._fanout.submit(call_one, *hp))
                   for hp in attempt]
        results: List[Tuple[Tuple[str, int], Any]] = []
        errors: Dict[Tuple[str, int], Exception] = {
            hp: RpcError("circuit open (skipped)", method) for hp in skipped}
        for hp, fut in futures:
            try:
                results.append((hp, fut.result()))
            except Exception as e:  # noqa: BLE001 - tallied below
                errors[hp] = e
        if errors:
            total = len(attempt) + len(skipped)
            need = {STRICT: total, QUORUM: total // 2 + 1}.get(policy, 1)
            detail = "; ".join(f"{h}:{p}: {e}"
                               for (h, p), e in sorted(errors.items()))
            if len(results) < need:
                raise RpcError(
                    f"{method}: {len(errors)}/{total} member(s) failed "
                    f"(policy={policy}, need {need}): {detail}", method)
            _metrics.inc("proxy_degraded_total")
            self._degraded.flag = True
            log.warning("%s degraded (%s): serving %d/%d members; %s",
                        method, policy, len(results), total, detail)
        return results

    # -- per-routing handlers ------------------------------------------------

    def _handle_random(self, method: str, name: str, params,
                       update: bool = True) -> Any:
        """RANDOM routing with rotation: a transport failure moves on to
        another member.  Breaker-open members go last (at most one
        half-open probe a request, and it goes first, since an admitted
        probe must be attempted); one deadline budget spans the rotation
        in per-attempt slices; reads cycle up to retry.max_attempts
        forwards.  An update rotates only while its failure provably came
        before delivery (request_sent False)."""
        order = list(self._get_members(name))
        self._rng.shuffle(order)
        probe = None
        closed: List[Tuple[str, int]] = []
        blocked: List[Tuple[str, int]] = []
        for hp in order:
            if not self.health.is_open(hp):
                closed.append(hp)
            elif probe is None and self.health.allow(hp):
                probe = hp
            else:
                blocked.append(hp)
        candidates = ([probe] if probe is not None else []) + closed + blocked
        attempts = len(candidates)
        if not update and self.retry is not None:
            attempts = max(attempts, self.retry.max_attempts)
        deadline = time.monotonic() + self.timeout
        last: Optional[Exception] = None
        for i in range(attempts):
            host, port = candidates[i % len(candidates)]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                result = self._forward_one(
                    host, port, method, (name, *params),
                    timeout=remaining / max(attempts - i, 1), update=update)
                if i:
                    _metrics.inc("proxy_failover_total")
                return result
            except TRANSPORT_ERRORS as e:
                last = e
                if update and e.request_sent:
                    break
        if last is None:
            last = RpcTimeoutError(
                f"deadline budget exhausted calling {method}", method)
        raise last

    def _handle_broadcast(self, method: str, agg: str, name: str, params,
                          update: bool = True, hosts=None) -> Any:
        """`hosts`: the target set the cache keyed the read on."""
        results = self._scatter_results(
            hosts if hosts is not None else self._get_members(name),
            method, (name, *params), update=update)
        return aggregate(agg, [r for _, r in results])

    def _handle_cht(self, method: str, agg: str, replicas: int,
                    first_success: bool, name: str, params,
                    update: bool = True, owners=None) -> Any:
        if not params:
            raise RpcError(f"{method}: cht routing requires a key argument")
        if owners is None:
            owners = self._cht(name).find(str(to_str(params[0])), replicas)
        if not owners:
            raise RpcError(f"no server found for {self.engine_type}/{name}")
        if first_success:
            # the owners are replicas of the same rows: fail over primary
            # -> replica instead of failing on any one
            last: Exception = RpcError("no owners")
            for host, port in owners:
                try:
                    return self._forward_one(host, port, method,
                                             (name, *params), update=update)
                except Exception as e:  # noqa: BLE001 - the next owner
                    last = e
            raise last
        results = self._scatter_results(owners, method, (name, *params),
                                        update=update)
        return aggregate(agg, [r for _, r in results])

    def _handle_partition_read(self, m: Method, name: str, params,
                               hosts=None) -> Any:
        """Partition-mode scatter-gather (framework/partition.py): every
        member sweeps its own range and the proxy merges.  A from_id read
        resolves its query payload at the id's ring owner first, then at
        the other members (mid-handoff a fresh owner may not hold the row
        yet): a row missing everywhere raises (the NN contract) or
        answers [] (the recommender's).  A lost partition follows the
        partial-failure policy as a broadcast read does."""
        spec = m.partition
        members = hosts if hosts is not None else self._get_members(name)
        _metrics.inc("partition_scatter_total")
        scatter_params = params
        method = spec.scatter or m.name
        if spec.fetch is not None:
            if not params:
                raise RpcError(f"{m.name}: partition routing requires a "
                               f"key argument")
            owners = self._cht(name).find(str(to_str(params[0])), 1)
            if not owners:
                raise RpcError(
                    f"no server found for {self.engine_type}/{name}")
            payload = None
            miss: Optional[Exception] = None
            fetch_order = [tuple(owners[0])] + [
                hp for hp in map(tuple, members) if hp != tuple(owners[0])]
            for host, port in fetch_order:
                try:
                    payload = self._forward_one(host, port, spec.fetch,
                                                (name, params[0]),
                                                update=False)
                except RemoteError as e:
                    miss = e          # the NN contract: no such row raises
                    continue
                if payload is not None:
                    break
            if payload is None:
                if miss is not None:
                    raise miss
                return []             # the recommender contract
            scatter_params = (payload, *params[1:])
        parts = self._scatter_results(members, method,
                                      (name, *scatter_params), update=False)
        cht = self._cht(name)

        def owner_of(id_: str):
            owners = cht.find_cached(id_, 1)
            return tuple(owners[0]) if owners else None

        t0 = time.monotonic()
        n_cand = sum(len(r[2] if spec.merge == "anomaly" and r else r or [])
                     for _, r in parts)
        if spec.merge == "anomaly":
            merged = merge_anomaly_score(parts, owner_of=owner_of)
        else:
            k = int(params[-1]) if len(params) > 1 else 0
            merged = merge_topk(parts, k, spec.ascending, owner_of=owner_of)
        _metrics.observe_value("partition_merge_size", float(n_cand))
        if _tracer.enabled:
            _tracer.record("proxy.partition_merge", time.monotonic() - t0,
                           method=m.name, partitions=len(parts),
                           candidates=n_cand)
        return merged

    # -- registration --------------------------------------------------------

    def _register_all(self) -> None:
        for m in SERVICES[self.engine_type].methods.values():
            if m.routing == INTERNAL:
                continue            # server-to-server only
            self.rpc.add(m.name, self._make_handler(m), threaded=True)
        # the common RPCs: get_config random; save, load, clear and
        # get_status broadcast (do_mix is a per-server control, not
        # proxied).  save/load/clear are updates, so the partial-failure
        # policy never degrades them: a broadcast write that skipped a
        # member would fork the cluster's state
        self.rpc.add("get_config", self._make_handler(
            Method("get_config", None, routing=RANDOM)), threaded=True)
        for mname, agg, upd in (("save", AGG_MERGE, True),
                                ("load", AGG_ALL_AND, True),
                                ("clear", AGG_ALL_AND, True),
                                ("get_status", AGG_MERGE, False),
                                # the members' metrics maps and span
                                # rings, merged as get_status is
                                ("get_metrics", AGG_MERGE, False),
                                ("get_traces", AGG_MERGE, False),
                                # the admission plane: a drop reaches
                                # every member of the named cluster (an
                                # update: a partial drop would fork the
                                # slot set); the listing merges theirs
                                ("drop_model", AGG_ALL_AND, True),
                                ("list_models", AGG_MERGE, False)):
            self.rpc.add(mname, self._make_handler(
                Method(mname, None, routing=BROADCAST, aggregator=agg,
                       update=upd)), threaded=True)
        self.rpc.add("create_model", self._create_model, threaded=True)
        self.rpc.add("get_proxy_status", lambda: self.get_proxy_status())
        # the proxy's OWN process metrics and spans
        self.rpc.add("get_proxy_metrics", lambda: self.metrics_snapshot())
        self.rpc.add("get_proxy_traces", lambda: _tracer.snapshot())
        for mname, item in LATER_RPCS.items():
            self.rpc.add(mname, self._refuse(mname, item))

    @staticmethod
    def _refuse(mname: str, item: str):
        def handler(*_args):
            raise NotImplementedError(later_refusal(mname, item))
        return handler

    def _create_model(self, name, spec=None, *rest):
        """create_model, broadcast to every member of the named cluster
        as an update (AGG_ALL_AND).  The epoch bumps even when it failed:
        a partial admission may have landed on some members."""
        with self._stat_lock:
            self.request_count += 1
        name = to_str(name)
        spec = dict(spec or {})
        if spec.get("placement", spec.get(b"placement")):
            raise NotImplementedError(later_refusal(
                "a create_model placement directive", "7"))
        spec.pop("placement", None)
        spec.pop(b"placement", None)
        try:
            return self._handle_broadcast("create_model", AGG_ALL_AND, name,
                                          (spec, *rest), update=True)
        finally:
            self._bump_epoch(name)

    # reads whose answers are volatile by design (operator counters, the
    # live slot registry), never cached even where the routing qualifies
    _NO_CACHE = frozenset({"get_status", "get_metrics", "get_traces",
                           "list_models"})

    def _route(self, m: Method, name: str, params, hosts=None) -> Any:
        if self.routing == "partition":
            if m.partition is not None and not m.update:
                return self._handle_partition_read(m, name, params,
                                                   hosts=hosts)
            if m.routing == CHT_ROUTING:
                # ownership, not replication: every point op goes to the
                # key's one ring owner
                return self._handle_cht(m.name, m.aggregator, 1,
                                        not m.update, name, params,
                                        update=m.update, owners=hosts)
        if m.routing == RANDOM:
            return self._handle_random(m.name, name, params,
                                       update=m.update)
        if m.routing == BROADCAST:
            return self._handle_broadcast(m.name, m.aggregator, name,
                                          params, update=m.update,
                                          hosts=hosts)
        if m.routing == CHT_ROUTING:
            first_success = not m.update and m.aggregator == AGG_PASS
            return self._handle_cht(m.name, m.aggregator, m.cht_replicas,
                                    first_success, name, params,
                                    update=m.update, owners=hosts)
        raise RpcError(f"unroutable method {m.name}")

    def _make_handler(self, m: Method):
        # a nolock method (anomaly's add) mutates the members as an
        # update does: both bump the cluster's epoch
        mutating = m.update or m.nolock

        def handler(name, *params):
            with self._stat_lock:
                self.request_count += 1
            name = to_str(name)
            if m.fn is not None:
                # engine traffic (the common and admission RPCs carry no
                # fn): the tenant's token bucket, keyed on (model name,
                # kind), rejects before any forward
                self.quota_gate.admit(name, _Q_TRAIN if mutating
                                      else _Q_QUERY)
            if mutating:
                try:
                    return self._route(m, name, params)
                finally:
                    # even when the forward FAILED: a partial broadcast
                    # or CHT write may have applied on some members
                    self._bump_epoch(name)
            cache = self.query_cache
            partition_read = (self.routing == "partition"
                              and m.partition is not None)
            if (cache is None or m.name in self._NO_CACHE
                    or (m.routing not in (BROADCAST, CHT_ROUTING)
                        and not partition_read)):
                return self._route(m, name, params)
            # the target set is part of the key (the answer aggregates
            # exactly these members; a membership change re-keys for
            # free); a ring change the set cannot express bumps the epoch
            self._check_ring_epoch(name)
            if m.routing == BROADCAST or partition_read:
                hosts = self._get_members(name)
            else:
                if not params:
                    raise RpcError(
                        f"{m.name}: cht routing requires a key argument")
                hosts = self._cht(name).find(
                    str(to_str(params[0])),
                    1 if self.routing == "partition" else m.cht_replicas)
            extra = (name + "|" + ";".join(
                f"{h}:{p}" for h, p in sorted(tuple(hp) for hp in hosts))
            ).encode()
            key = cache.key(m.name, params, self._epoch(name), extra=extra)

            def compute():
                self._degraded.flag = False
                return self._route(m, name, params, hosts=hosts)
            # a degraded answer is served once, never replayed
            return serve_cached(
                cache, key, compute,
                fill_ok=lambda: not getattr(self._degraded, "flag", False))
        return handler

    # -- status --------------------------------------------------------------

    def metrics_snapshot(self) -> Dict[str, str]:
        """The proxy's flat counter map: what the exporter serves,
        get_proxy_metrics answers and get_proxy_status merges."""
        with self._stat_lock:
            _metrics.set_gauge("proxy_request_count",
                               float(self.request_count))
            _metrics.set_gauge("proxy_forward_count",
                               float(self.forward_count))
        out: Dict[str, str] = {}
        if self.query_cache is not None:
            out.update(self.query_cache.get_status())
        out.update(self.health.snapshot())       # the breakers
        # retry, failover, degrade, partition and rpc counters
        out.update(_metrics.snapshot())
        return out

    def get_proxy_status(self) -> Dict[str, Dict[str, str]]:
        loc = build_loc_str(self.ip, self.port) if self.port else "unbound"
        with self._stat_lock:
            requests, forwards = self.request_count, self.forward_count
        st = {
            "request_count": str(requests),
            "forward_count": str(forwards),
            "uptime": str(int(time.time() - self.start_time)),
            "type": self.engine_type,
            "timeout": str(self.timeout),
            "routing": self.routing,
            "partial_failure": self.partial_failure,
            "retry_max_attempts": str(self.retry.max_attempts
                                      if self.retry else 1),
            "pid": str(os.getpid()),
            "version": jubatus_tpu_torch.__version__,
            "query_cache_enabled": str(int(self.query_cache is not None)),
            "tracing_enabled": str(int(_tracer.enabled)),
            "metrics_port": str(self.metrics_exporter.port
                                if self.metrics_exporter is not None else 0),
        }
        st.update(self.metrics_snapshot())
        return {loc: st}

    # -- lifecycle -----------------------------------------------------------

    def start(self, port: int, host: str = "0.0.0.0",
              advertised_ip: str = "127.0.0.1") -> int:
        self.ip = advertised_ip
        self.port = self.rpc.start(port, host=host)
        # an entry a crashed predecessor on this ip:port left is replaced
        path = f"{PROXY_BASE}/{build_loc_str(self.ip, self.port)}"
        if not create_or_replace_ephemeral(self.ls, path):
            raise RuntimeError(f"cannot register proxy at {path}")
        return self.port

    def stop(self) -> None:
        self.rpc.stop()
        if self.metrics_exporter is not None:
            self.metrics_exporter.stop()
        self._fanout.shutdown(wait=False)
        self.pool.close()
        if self._own_ls:
            self.ls.close()
