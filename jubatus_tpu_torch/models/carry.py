"""Move classifier state between the JAX package and the port.

load_reference_state(driver, arrays) installs a JAX ClassifierDriver's
state, handed over as host data, on the port driver's device;
export_reference_state(driver) is its inverse.  `arrays` holds what the
JAX driver's pack() holds (jubatus_tpu/models/classifier.py
ClassifierDriver.pack), with the tables as numpy arrays:

    w, cov      [L, D] float32      (cov only for CW/AROW/NHERD)
    counts      [L] int32
    active      [L] bool
    labels      {label: row}
    weights     {"df": uint32 [D], "doc_count": int,
                 "user_weights": float32 [D]}   (arrays or raw bytes)

This module imports nothing of the JAX package: the caller reads the JAX
driver's arrays (np.asarray) and passes them in.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from jubatus_tpu_torch.models.classifier import ClassifierDriver, _has_cov


def _raw(a, dtype) -> bytes:
    if isinstance(a, (bytes, bytearray)):
        return bytes(a)
    return np.ascontiguousarray(np.asarray(a, dtype)).tobytes()


def load_reference_state(driver: ClassifierDriver,
                         arrays: Dict[str, Any]) -> None:
    w = np.asarray(arrays["w"], np.float32)
    if w.ndim != 2 or w.shape[1] != driver.dim:
        raise ValueError(f"w shape {w.shape} does not match dim {driver.dim}")
    weights = arrays["weights"]
    obj = {
        "labels": dict(arrays["labels"]),
        "capacity": w.shape[0],
        "w": _raw(w, np.float32),
        "counts": _raw(arrays["counts"], np.int32),
        "active": _raw(arrays["active"], bool),
        "weights": {"df": _raw(weights["df"], np.uint32),
                    "doc_count": int(weights["doc_count"]),
                    "user_weights": _raw(weights["user_weights"],
                                         np.float32)},
    }
    if _has_cov(driver.method):
        obj["cov"] = _raw(arrays["cov"], np.float32)
    driver.unpack(obj)


def export_reference_state(driver: ClassifierDriver) -> Dict[str, Any]:
    wm = driver.converter.weights
    out = {
        "w": driver.w.cpu().numpy(),
        "counts": driver.counts.cpu().numpy(),
        "active": driver.active.cpu().numpy(),
        "labels": dict(driver.labels),
        "weights": {"df": wm.df.copy(), "doc_count": wm.doc_count,
                    "user_weights": wm.user_weights.copy()},
    }
    if _has_cov(driver.method):
        out["cov"] = driver.cov.cpu().numpy()
    return out
