"""Epoch-tagged read-result cache of the query plane (the port's copy of
jubatus_tpu/framework/query_cache.py).

An answer must never predate an update whose RPC already returned, so
the model version is part of the key: entries are keyed on (method,
hash of the canonical arguments, model_epoch), where model_epoch is a
counter bumped by every model mutation (train, the row writes and drops,
clear, load and --model_file, a MIX fold, a straggler catch-up or
bootstrap, journal recovery).  Invalidation is therefore free: a bumped
epoch never matches again, and stale entries age out of the LRU.

Entries hold the msgpack-ENCODED response body (the old wire spec of
rpc/server._reply), so a hit skips the device sweep and the encode: the
RPC layer splices the bytes into the response frame (rpc/server.py
PreEncoded).  Bounded by entry count and by total bytes (0 leaves an
axis unbounded; both 0 turns the cache off).  Traffic counts
query_cache_{hit,miss,evict,bypass}_total.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from jubatus_tpu_torch.mix.codec import packb as _packb
from jubatus_tpu_torch.rpc.server import PreEncoded
from jubatus_tpu_torch.utils import metrics as _metrics


def pack_wire(obj) -> bytes:
    """Pack a decoded result the way rpc/server._reply does (OLD-spec
    msgpack: raw family only, surrogateescape for binary-in-str), so a
    cached body is byte-identical to what the normal path would send.
    Delegates to mix/codec.packb — the one place the wire-spec msgpack
    options are pinned."""
    return _packb(obj)


class QueryCache:
    """Bounded LRU of pre-encoded read responses, epoch-keyed."""

    def __init__(self, max_entries: int = 0, max_bytes: int = 0,
                 registry: "_metrics.Registry" = None,
                 prefix: str = "query_cache"):
        self.max_entries = max(0, int(max_entries))
        self.max_bytes = max(0, int(max_bytes))
        self._registry = registry if registry is not None else _metrics.GLOBAL
        self._prefix = prefix
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, bytes]" = OrderedDict()
        self._bytes = 0

    # -- keys ----------------------------------------------------------------

    def key(self, method: str, args, epoch: int,
            extra: bytes = b"") -> Optional[Tuple]:
        """Canonical cache key, or None (bypass) when the arguments do
        not pack deterministically.  Wire arguments arrive as plain
        msgpack-decoded structures, so re-packing them is the canonical
        form; `extra` folds in routing context (the proxy's target
        set)."""
        try:
            blob = pack_wire(list(args))
        except Exception:
            self._registry.inc(f"{self._prefix}_bypass_total")
            return None
        digest = hashlib.blake2b(blob, digest_size=16).digest()
        return (method, digest, int(epoch), extra)

    # -- lookup / store ------------------------------------------------------

    def get(self, key) -> Optional[bytes]:
        if key is None:
            return None
        with self._lock:
            body = self._entries.get(key)
            if body is not None:
                self._entries.move_to_end(key)
        self._registry.inc(f"{self._prefix}_hit_total" if body is not None
                           else f"{self._prefix}_miss_total")
        return body

    def put(self, key, body: bytes) -> None:
        if key is None:
            return
        if self.max_bytes and len(body) > self.max_bytes:
            # one response bigger than the whole budget: caching it would
            # just evict everything else for a single-entry cache
            self._registry.inc(f"{self._prefix}_bypass_total")
            return
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = body
            self._bytes += len(body)
            while ((self.max_entries and len(self._entries) > self.max_entries)
                   or (self.max_bytes and self._bytes > self.max_bytes)):
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= len(dropped)
                evicted += 1
        if evicted:
            self._registry.inc(f"{self._prefix}_evict_total", evicted)

    def bypass(self) -> None:
        """Record a read that could not use the cache (unpackable args,
        oversized body, non-cacheable method)."""
        self._registry.inc(f"{self._prefix}_bypass_total")

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stored_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def get_status(self):
        with self._lock:
            n, b = len(self._entries), self._bytes
        return {
            f"{self._prefix}_entries": str(n),
            f"{self._prefix}_bytes": str(b),
            f"{self._prefix}_max_entries": str(self.max_entries),
            f"{self._prefix}_max_bytes": str(self.max_bytes),
        }


def serve_cached(cache: Optional[QueryCache], key, compute, fill_ok=None):
    """The probe/compute/fill state machine shared by the server read
    handler (framework/service.py) and the proxy read handler
    (framework/proxy.py): a hit returns the pre-encoded body; a miss
    computes, packs ONCE, fills, and serves its own encode (so a fill
    never double-packs); results that will not pack bypass the cache and
    are served direct.  `key` is None when the cache is off or the
    arguments did not pack — then this is just compute().  `fill_ok`,
    checked AFTER compute, lets the caller veto the fill for answers
    that are correct to serve once but wrong to replay (the proxy's
    degraded partial-failure aggregates)."""
    if key is not None:
        body = cache.get(key)
        if body is not None:
            return PreEncoded(body)
    result = compute()
    if key is not None:
        if fill_ok is not None and not fill_ok():
            cache.bypass()      # e.g. degraded aggregate: serve direct
            return result
        try:
            body = pack_wire(result)
        except Exception:
            cache.bypass()      # unpackable result: serve direct
            return result
        cache.put(key, body)
        return PreEncoded(body)
    return result


def create_query_cache(max_entries: int, max_bytes: int,
                       registry: "_metrics.Registry" = None,
                       prefix: str = "query_cache") -> Optional[QueryCache]:
    """Both knobs 0 (the default) means OFF — return None so callers can
    gate on `cache is not None` with zero overhead."""
    if not max_entries and not max_bytes:
        return None
    return QueryCache(max_entries=max_entries, max_bytes=max_bytes,
                      registry=registry, prefix=prefix)
