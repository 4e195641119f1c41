"""Move model state between the JAX package and the port.

load_reference_state(driver, arrays) installs a JAX driver's state, handed
over as host data, on the port driver's device; export_reference_state
(driver) is its inverse.  `arrays` holds what the JAX driver's pack()
holds, with the tables as numpy arrays:

  classifier (jubatus_tpu/models/classifier.py ClassifierDriver.pack)
    w, cov      [L, D] float32      (cov only for CW/AROW/NHERD)
    counts      [L] int32
    active      [L] bool
    labels      {label: row}
  regression (jubatus_tpu/models/regression.py RegressionDriver.pack)
    w           [D] float32
    num_trained int
  both
    weights     {"df": uint32 [D], "doc_count": int,
                 "user_weights": float32 [D]}   (arrays or raw bytes)

A data-parallel driver (jubatus_tpu/parallel/dp.py DPClassifierDriver,
DPRegressionDriver; the port's parallel/dp.py) carries its replicas
stacked, so two packages can start from the same diverged replicas:
w, cov [ndp, L, D] (regression w [ndp, D]), counts, active [ndp, L], and
the device bases w_dbase, cov_dbase, counts_dbase of the same shapes.

This module imports nothing of the JAX package: the caller reads the JAX
driver's arrays (np.asarray) and passes them in.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np

from jubatus_tpu_torch.models.classifier import ClassifierDriver, _has_cov
from jubatus_tpu_torch.models.regression import RegressionDriver


def _raw(a, dtype) -> bytes:
    if isinstance(a, (bytes, bytearray)):
        return bytes(a)
    return np.ascontiguousarray(np.asarray(a, dtype)).tobytes()


def _weights(weights) -> Dict[str, Any]:
    return {"df": _raw(weights["df"], np.uint32),
            "doc_count": int(weights["doc_count"]),
            "user_weights": _raw(weights["user_weights"], np.float32)}


def _load_stacked(driver, arrays: Dict[str, Any]) -> None:
    """Install a data-parallel driver's stacked replicas and device bases
    (the host-level state first, through the driver's unpack)."""
    import torch
    dev = driver.device

    def put(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype,
                                         copy=True)).to(dev)

    w = np.asarray(arrays["w"], np.float32)
    if w.shape[0] != driver.ndp:
        raise ValueError(f"{w.shape[0]} replicas do not match the driver's "
                         f"{driver.ndp}")
    single = {k: (v[0] if k in ("w", "cov", "counts", "active") else v)
              for k, v in arrays.items() if not k.endswith("_dbase")}
    _load_plain(driver, single)
    driver.w, driver.w_dbase = put("w", np.float32), put("w_dbase",
                                                          np.float32)
    if isinstance(driver, RegressionDriver):
        return
    driver.counts = put("counts", np.int32)
    driver.counts_dbase = put("counts_dbase", np.int32)
    driver.active = put("active", bool)
    if _has_cov(driver.method):
        driver.cov = put("cov", np.float32)
        driver.cov_dbase = put("cov_dbase", np.float32)


def load_reference_state(driver: Union[ClassifierDriver, RegressionDriver],
                         arrays: Dict[str, Any]) -> None:
    if hasattr(driver, "ndp"):
        _load_stacked(driver, arrays)
    else:
        _load_plain(driver, arrays)


def _load_plain(driver, arrays: Dict[str, Any]) -> None:
    w = np.asarray(arrays["w"], np.float32)
    if isinstance(driver, RegressionDriver):
        if w.shape != (driver.dim,):
            raise ValueError(f"w shape {w.shape} does not match dim "
                             f"{driver.dim}")
        driver.unpack({"method": driver.method, "w": _raw(w, np.float32),
                       "num_trained": int(arrays["num_trained"]),
                       "weights": _weights(arrays["weights"])})
        return
    if w.ndim != 2 or w.shape[1] != driver.dim:
        raise ValueError(f"w shape {w.shape} does not match dim {driver.dim}")
    obj = {
        "labels": dict(arrays["labels"]),
        "capacity": w.shape[0],
        "w": _raw(w, np.float32),
        "counts": _raw(arrays["counts"], np.int32),
        "active": _raw(arrays["active"], bool),
        "weights": _weights(arrays["weights"]),
    }
    if _has_cov(driver.method):
        obj["cov"] = _raw(arrays["cov"], np.float32)
    driver.unpack(obj)


def export_reference_state(driver: Union[ClassifierDriver, RegressionDriver]
                           ) -> Dict[str, Any]:
    wm = driver.converter.weights
    out = {
        "w": driver.w.cpu().numpy(),
        "weights": {"df": wm.df.copy(), "doc_count": wm.doc_count,
                    "user_weights": wm.user_weights.copy()},
    }
    stacked = hasattr(driver, "ndp")
    if stacked:
        out["w_dbase"] = driver.w_dbase.cpu().numpy()
    if isinstance(driver, RegressionDriver):
        out["num_trained"] = driver.num_trained
        return out
    out.update(counts=driver.counts.cpu().numpy(),
               active=driver.active.cpu().numpy(),
               labels=dict(driver.labels))
    if stacked:
        out["counts_dbase"] = driver.counts_dbase.cpu().numpy()
    if _has_cov(driver.method):
        out["cov"] = driver.cov.cpu().numpy()
        if stacked:
            out["cov_dbase"] = driver.cov_dbase.cpu().numpy()
    return out
