"""Driver protocol and registry (twin of jubatus_tpu/models/base.py).

A Driver owns model state (torch tensors on one device + small host-side
dictionaries), exposes the engine's RPC-level methods, the linear-mixable
diff algebra for MIX, and msgpack-able pack/unpack for the model file.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

DRIVERS: Dict[str, Callable[..., "Driver"]] = {}


class RawBatch:
    """N raw train frames fused into one packed [idx | val | aux | mask]
    arena (the JAX package's native batched-convert result).  The port's
    native ingest path is later work; the type is kept so the driver
    surface matches.

    gen    — the driver's conversion generation (stale-table guard)
    frames — the [(msg_bytes, params_off), ...] list
    ns     — per-frame datum counts (the per-request RPC results)
    b, k   — the fused padded shape
    arena  — the packed blob
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
      get_diff() -> diff object (msgpack-able host pytree)
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

    def encode_diff(self, snap: Any) -> Any:
        return snap

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
