"""Driver protocol and registry (twin of jubatus_tpu/models/base.py).

A Driver owns model state (torch tensors on one device + small host-side
dictionaries), exposes the engine's RPC-level methods, the linear-mixable
diff algebra for MIX, and msgpack-able pack/unpack for the model file.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from jubatus_tpu_torch.analysis.lockgraph import MONITOR as _lock_monitor

DRIVERS: Dict[str, Callable[..., "Driver"]] = {}


class RawBatch:
    """One native batched-convert result: N raw train frames fused into a
    single packed [idx | val | aux | mask] arena by _fastconv.c's
    convert_raw_batch (see models/classifier.convert_raw_batch).

    gen    — the driver's _fast_gen at conversion time (stale-table guard)
    frames — the [(msg_bytes, params_off), ...] list
    ns     — per-frame datum counts (the per-request RPC results)
    b, k   — the fused padded shape (0 rows when every frame was empty)
    arena  — the packed blob (np.uint8 from an ArenaPool, pinned for a
             cuda driver), None when b is 0
    need   — rows interned past capacity (deferred _grow)
    """

    __slots__ = ("gen", "frames", "ns", "b", "k", "arena", "need")

    def __init__(self, gen, frames, ns, b, k, arena, need=0):
        self.gen = gen
        self.frames = frames
        self.ns = ns
        self.b = b
        self.k = k
        self.arena = arena
        self.need = need

    @property
    def total(self) -> int:
        return sum(self.ns)


def register_driver(name: str):
    def deco(cls):
        DRIVERS[name] = cls
        cls.service_name = name
        return cls
    return deco


def create_driver(service: str, config: Dict[str, Any],
                  device=None) -> "Driver":
    """config is the full engine config JSON: {method, parameter,
    converter}; device is where the model state lives (None = cuda)."""
    if service not in DRIVERS:
        raise ValueError(f"unknown service: {service!r} (have {sorted(DRIVERS)})")
    return DRIVERS[service](config, device=device)


class Driver:
    """Base class; engines override what they support.

    MIX contract (the get_diff/mix/put_diff algebra of linear_mixable):
      get_diff() -> diff object (msgpack-able host pytree); the mixer
          takes it as get_diff_snapshot() under the model write lock
          and encode_diff() outside it
      mix(lhs, rhs) -> merged diff (associative)
      put_diff(diff) -> apply cluster-merged diff; returns freshness bool
    """

    service_name = "base"
    device = None

    def __init__(self, config: Dict[str, Any]):
        self.config = config

    # -- mixable -----------------------------------------------------------
    def get_diff(self) -> Any:
        return None

    def get_diff_snapshot(self) -> Any:
        """The mixer's lock-phase split: called UNDER the model write
        lock, it only snapshots (device gathers to the host, copies of
        the bases).  Default: the whole diff."""
        return self.get_diff()

    def encode_diff(self, snap: Any) -> Any:
        """Called WITHOUT the model lock on a snapshot (or a finished
        diff): the subtraction and transport encoding, so trains proceed
        meanwhile.  Default: identity."""
        return snap

    @staticmethod
    def _subtract_bases(snap: Dict[str, Any]) -> Dict[str, Any]:
        """A snapshot's diff: each table `name` minus its copied base
        `name_base`, in the key order of the finished diff.  A finished
        diff (no base keys) comes back as it is."""
        if not any(k.endswith("_base") for k in snap):
            return snap
        return {k: (v - snap[k + "_base"] if k + "_base" in snap else v)
                for k, v in snap.items() if not k.endswith("_base")}

    @classmethod
    def mix(cls, lhs: Any, rhs: Any) -> Any:
        return lhs

    def put_diff(self, diff: Any) -> bool:
        return True

    # -- persistence -------------------------------------------------------
    def pack(self) -> Any:
        raise NotImplementedError

    def unpack(self, obj: Any) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def get_status(self) -> Dict[str, str]:
        return {}

    # -- sublinear query index (jubatus_tpu_torch/index/) ---------------------
    # The row-store engines override configure_index; every other driver
    # declines (returns False), so --index on a classifier is a visible
    # no-op, not a crash.
    index = None

    def configure_index(self, kind: str, probes: int = 4, **kw) -> bool:
        return False

    def _index_spec_kwargs(self, kw: Dict[str, Any]) -> Dict[str, Any]:
        """Config-level index tuning: the engine config's optional "index"
        object supplies the IndexSpec fields the CLI does not expose
        (min_rows, bits, delta_cap, embed_dim, centroids; e.g.
        `"index": {"min_rows": 0}` for a small table); explicit kwargs
        win."""
        cfg = {k: int(v) for k, v in
               dict(self.config.get("index") or {}).items()
               if k in ("min_rows", "bits", "delta_cap", "embed_dim",
                        "centroids")}
        cfg.update(kw)
        return cfg

    def _index_put(self, a: np.ndarray) -> torch.Tensor:
        """A host CSR or centroid array on the driver's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _index_for_query(self):
        """The engaged, built index, or None when the full sweep serves
        (no index, or the table below min_rows).  Needs the row-store
        shape (self.ids and _index_rebuild); re-derived under the index's
        rebuild lock, checked twice, so one query thread rebuilds after a
        wholesale table change or an IVF 2x-growth retrain.  Callers whose
        host rows reach the device lazily (recommender, anomaly _sync)
        sync first: the rebuild reads the device tables.  A spilled table
        has no whole-table device view for the candidate gather, so it
        bypasses the index: its reads sweep exactly (ops/paged.py), as the
        JAX driver's do."""
        idx = self.index
        if idx is None or not idx.engaged(len(self.ids)):
            return None
        pages = getattr(self, "pages", None)
        if pages is not None and pages.spill_mode:
            return None
        if idx.stale(len(self.ids)):
            with idx.rebuild_lock:
                if idx.stale(len(self.ids)):
                    self._index_rebuild()
        return idx if idx.ready else None

    def _index_rebuild(self) -> None:   # pragma: no cover - overridden
        raise NotImplementedError

    def take_index_sweep_stats(self):
        """(candidates, rows, fallback) of this thread's last indexed
        sweep, or None when no index ran."""
        idx = self.index
        return idx.take_stats() if idx is not None else None

    def query_tier_status(self) -> str:
        """Where the row engines' query tables live: the driver's device
        (the JAX package may mirror them to a host tier,
        utils/placement.py; the port keeps them where the model is)."""
        return str(self.device)

    def device_sync(self) -> None:
        """Block until the work queued on this driver's device stream has
        executed (the JAX driver blocks on one model leaf).  The ingest
        pipeline calls it every few fused steps: it bounds the queued
        backlog and fences the host arenas those steps copied from."""
        _lock_monitor.note_blocking("device_sync")  # never under the write lock
        dev = self.device
        if dev is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    # -- column-sparse DCN diff bookkeeping ---------------------------------
    # Requires: self._touched_cols (bool[dim]), self._unconfirmed_cols
    # (int32[] | None), self.dcn_payload.

    def _harvest_touched_cols(self) -> "np.ndarray":
        """Columns for this round's diff: touched since the last harvest,
        plus any still-unconfirmed from a round that never confirmed."""
        J = np.flatnonzero(self._touched_cols).astype(np.int32)
        if self._unconfirmed_cols is not None:
            J = np.union1d(J, self._unconfirmed_cols).astype(np.int32)
        self._touched_cols[:] = False
        self._unconfirmed_cols = J
        return J

    # --mix_topk (the server sets it on each slot's driver): ship only the
    # mix_topk columns of largest |w| delta of a col-sparse linear diff a
    # round; 0 ships every touched column (the default)
    mix_topk = 0

    def _sparsify_topk(self, diff: Dict[str, Any],
                       keys=("w", "cov")) -> Dict[str, Any]:
        """Top-k delta sparsification (jubatus_tpu/models/base.py
        _sparsify_topk): keep the mix_topk columns with the largest |w|
        delta (over the rows); the rest stay in _unconfirmed_cols and ship
        on a later round.  Best-effort deferral: a dropped column keeps its
        local training until it ships, and a column a peer ships first
        adopts the cluster's value (put_diff's rule).  Bitwise per-round
        replica agreement holds only at 0."""
        k = int(getattr(self, "mix_topk", 0) or 0)
        cols = diff.get("cols") if isinstance(diff, dict) else None
        if k <= 0 or cols is None:
            return diff
        cols = np.asarray(cols)
        w = np.asarray(diff.get("w"), np.float32)
        if cols.size <= k or not w.size:
            return diff
        score = np.abs(w).max(axis=0) if w.ndim == 2 else np.abs(w)
        keep = np.sort(np.argpartition(score, -k)[-k:])
        out = dict(diff)
        out["cols"] = cols[keep]
        for name in keys:
            a = out.get(name)
            if a is None:
                continue
            a = np.asarray(a)
            if a.size:
                out[name] = a[:, keep] if a.ndim == 2 else a[keep]
        return out

    def _quantize_diff_payload(self, diff: Dict[str, Any],
                               keys=("w", "cov")) -> Dict[str, Any]:
        """Optional per-row int8 transport quantization
        ({"dcn_payload": "int8"}) of a non-empty column-sparse diff."""
        if self.dcn_payload != "int8" or diff.get("cols") is None \
                or not np.asarray(diff["w"]).size:
            return diff
        from jubatus_tpu_torch.mix.codec import Quantized
        diff = dict(diff)
        for name in keys:
            if name in diff:
                diff[name] = Quantized(diff[name])
        return diff

    def _retire_confirmed_cols(self, cols) -> None:
        """Retire ONLY columns this round actually covered."""
        if self._unconfirmed_cols is None:
            return
        if cols is None:                 # dense round covers everything
            self._unconfirmed_cols = None
        else:
            left = np.setdiff1d(self._unconfirmed_cols,
                                np.asarray(cols, np.int64))
            self._unconfirmed_cols = left.astype(np.int32) \
                if left.size else None
