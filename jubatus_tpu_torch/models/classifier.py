"""Multi-class online linear classifiers on one torch device (counterpart
of jubatus_tpu/models/classifier.py).

Methods: perceptron, PA, PA1, PA2, CW, AROW, NHERD (margin methods, dense
[L, D] weight and diagonal-covariance tables over the hashed feature
space) and cosine, euclidean (per-label centroid sums).

Train is one device step per microbatch.  The default "sequential" mode
keeps the reference's strict per-datum order: on CUDA it is ONE launch of
the hand-written scan kernel (csrc/train_scan.cu) over the whole packed
batch; train_scan_ref is its plain PyTorch version, step for step the JAX
package's train_scan_impl.  The opt-in "parallel" mode and classify are
plain tensor ops (one gather, one scatter-add, one scatter-multiply), as
they are plain XLA ops in the JAX package.  State tensors are updated in
place — the port's counterpart of the JAX package's donated buffers.

MIX: get_diff exports (w - w_base) over the columns touched since the
last round, keyed by label strings; mix sums; put_diff applies the mean
delta and resnapshots the base — the same host algebra as the JAX driver.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.batching.bucketing import (round_b as _round_b,
                                                  split_groups)
from jubatus_tpu_torch.device import resolve_device
from jubatus_tpu_torch.fv import ConverterConfig, Datum, DatumToFVConverter
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.models.base import Driver, register_driver
from jubatus_tpu_torch.ops.sparse import batch_scores, sample_scores

MARGIN_METHODS = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")
CENTROID_METHODS = ("cosine", "euclidean")
# method ids of csrc/train_scan.cu (enum Method)
_METHOD_ID = {m: i for i, m in enumerate(MARGIN_METHODS)}


def _has_cov(method: str) -> bool:
    return method in ("CW", "AROW", "NHERD")


# ---------------------------------------------------------------------------
# sequential train step: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def _last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """[K] -> bool [K]: True where no later entry has the same index.  A
    scatter-SET with duplicate indices keeps the last write (XLA CPU
    order), so only these entries decide the stored value."""
    eq = idx[:, None] == idx[None, :]
    return ~torch.triu(eq, diagonal=1).any(dim=1)


def train_scan_ref(w, cov, counts, active, indices, values, labels, mask,
                   method: str, c: float) -> None:
    """Plain PyTorch version of the scan kernel: sequential online updates
    over one microbatch, in place.  Mirrors train_scan_impl of the JAX
    package expression by expression, in f32.

    w, cov: [L, D] f32   counts: [L] i32   active: [L] bool
    indices/values: [B, K]   labels: [B] i32   mask: [B] f32 (0 = padding)
    """
    dev = w.device
    cf = torch.tensor(c, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(indices.shape[0]):
        if not bool(mask[b] > 0):
            continue                       # padding datum: a no-op step
        idx = indices[b].long()
        val = values[b]
        y = int(labels[b])
        s = sample_scores(w, idx, val)                      # [L]
        active[y] = True
        counts[y] += 1
        rival = torch.where(active, s, neg_inf)
        rival[y] = neg_inf
        r = int(torch.argmax(rival))       # first maximum; 0 if all -inf
        margin = s[y] - rival[r]
        x2 = val * val
        sqn = x2.sum()
        if not (bool(torch.isfinite(rival[r])) and bool(sqn > 0)):
            continue                       # not ok: every table unchanged
        if method == "perceptron":
            alpha = torch.where(margin <= 0, 1.0, 0.0)
            dy, dr = alpha * val, -alpha * val
        elif method in ("PA", "PA1", "PA2"):
            loss = 1.0 - margin
            if method == "PA":
                tau = loss / (2.0 * sqn)
            elif method == "PA1":
                tau = torch.minimum(cf, loss / (2.0 * sqn))
            else:
                tau = loss / (2.0 * sqn + 0.5 / cf)
            tau = torch.where(loss > 0, tau, zero)
            dy, dr = tau * val, -tau * val
        else:
            cy = cov[y, idx]
            cr = cov[r, idx]
            v = (x2 * (cy + cr)).sum()
            if method == "AROW":
                beta = 1.0 / (v + cf)
                gate = margin < 1.0
                alpha = torch.where(gate, torch.clamp_min(1.0 - margin, 0.0)
                                    * beta, zero)
                g = torch.where(gate, beta, zero)
                dy = alpha * cy * val
                dr = -alpha * cr * val
                ncy = cy - g * cy * cy * x2
                ncr = cr - g * cr * cr * x2
            elif method == "CW":
                phi = cf
                t = 1.0 + 2.0 * phi * margin
                inner = t * t - 8.0 * phi * (margin - phi * v)
                gamma = (-t + torch.sqrt(torch.clamp_min(inner, 0.0))) / (
                    4.0 * phi * torch.clamp_min(v, 1e-12))
                alpha = torch.clamp_min(gamma, 0.0)
                dy = alpha * cy * val
                dr = -alpha * cr * val
                g = 2.0 * alpha * phi
                ncy = 1.0 / (1.0 / torch.clamp_min(cy, 1e-12) + g * x2)
                ncr = 1.0 / (1.0 / torch.clamp_min(cr, 1e-12) + g * x2)
            else:  # NHERD
                gate = margin < 1.0
                alpha = torch.where(gate, torch.clamp_min(1.0 - margin, 0.0)
                                    / (v + cf), zero)
                g = torch.where(gate, 2.0 * cf + cf * cf * v, zero)
                dy = alpha * cy * val
                dr = -alpha * cr * val
                denom = 1.0 + g * x2
                ncy = cy / denom
                ncr = cr / denom
            keep = _last_occurrence(idx)
            cov[y, idx[keep]] = ncy[keep]
            cov[r, idx[keep]] = ncr[keep]
        w[y].index_add_(0, idx, dy)
        w[r].index_add_(0, idx, dr)


def _scan_lib() -> ctypes.CDLL:
    lib = build.load("train_scan")
    lib.train_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.train_scan_launch.restype = ctypes.c_int
    return lib


def train_scan(w, cov, counts, active, indices, values, labels, mask,
               method: str, c: float) -> None:
    """Sequential online updates over one microbatch, in place.  CUDA
    tensors: one launch of csrc/train_scan.cu.  CPU tensors: the plain
    version.  Shapes as train_scan_ref; indices/labels int32."""
    if w.device.type == "cpu":
        train_scan_ref(w, cov, counts, active, indices, values, labels,
                       mask, method, c)
        return
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    b, k = indices.shape
    l, d = w.shape
    want = [(w, torch.float32), (counts, torch.int32), (active, torch.bool),
            (indices, torch.int32), (values, torch.float32),
            (labels, torch.int32), (mask, torch.float32)]
    if _has_cov(method):
        want.append((cov, torch.float32))
        if tuple(cov.shape) != (l, d):
            raise ValueError(f"cov shape {tuple(cov.shape)} != w {(l, d)}")
    for t, dt in want:
        if t.dtype != dt or t.device != w.device or not t.is_contiguous():
            raise ValueError(f"train_scan: want contiguous {dt} on "
                             f"{w.device}, got {t.dtype} on {t.device}")
    if tuple(values.shape) != (b, k) or labels.shape[0] != b \
            or mask.shape[0] != b or counts.shape[0] != l \
            or active.shape[0] != l:
        raise ValueError("train_scan: inconsistent batch/state shapes")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _scan_lib().train_scan_launch(
        w.data_ptr(), cov.data_ptr(), counts.data_ptr(), active.data_ptr(),
        indices.data_ptr(), values.data_ptr(), labels.data_ptr(),
        mask.data_ptr(), b, k, l, d, _METHOD_ID[method], float(c), stream)
    train_scan.launches += 1
    build.check(err, "train_scan launch")


train_scan.launches = 0


# ---------------------------------------------------------------------------
# parallel (mini-batch) mode, centroid methods and scoring: torch ops
# ---------------------------------------------------------------------------

def train_parallel(w, cov, counts, active, indices, values, labels, mask,
                   method: str, c: float) -> None:
    """Mini-batch online updates, in place (train_parallel_impl of the
    JAX package): every sample's margin is computed against the weights as
    of the START of the batch, then all updates land in one scatter-add
    (w) and one scatter-multiply (cov, factors clamped at >= 1e-6; a
    column hit twice in the batch compounds its factors)."""
    dev = w.device
    cf = torch.tensor(c, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    idx = indices.long()
    lab = labels.long()
    live = mask > 0                                          # [B]
    s = batch_scores(w, idx, values)                         # [B, L]
    brange = torch.arange(idx.shape[0], device=dev)

    counts.index_add_(0, lab, live.to(torch.int32))
    active |= counts > 0

    sy = s[brange, lab]
    rival = torch.where(active[None, :], s, float("-inf"))
    rival[brange, lab] = float("-inf")
    r = torch.argmax(rival, dim=1)                           # [B]
    rmax = rival[brange, r]
    margin = sy - rmax
    x2 = values * values                                     # [B, K]
    sqn = x2.sum(dim=1)
    ok = live & torch.isfinite(rmax) & (sqn > 0)

    fac_y = fac_r = None
    if method == "perceptron":
        alpha = torch.where(ok & (margin <= 0), 1.0, 0.0)
        dy = alpha[:, None] * values
        dr = -dy
    elif method in ("PA", "PA1", "PA2"):
        loss = 1.0 - margin
        if method == "PA":
            tau = loss / (2.0 * torch.clamp_min(sqn, 1e-12))
        elif method == "PA1":
            tau = torch.minimum(cf, loss / (2.0 * torch.clamp_min(sqn, 1e-12)))
        else:
            tau = loss / (2.0 * sqn + 0.5 / cf)
        tau = torch.where(ok & (loss > 0), tau, zero)
        dy = tau[:, None] * values
        dr = -dy
    else:
        cy = cov[lab[:, None], idx]                          # [B, K]
        cr = cov[r[:, None], idx]
        v = (x2 * (cy + cr)).sum(dim=1)                      # [B]
        if method == "AROW":
            beta = 1.0 / (v + cf)
            gate = ok & (margin < 1.0)
            alpha = torch.where(gate, torch.clamp_min(1.0 - margin, 0.0)
                                * beta, zero)
            dy = alpha[:, None] * cy * values
            dr = -alpha[:, None] * cr * values
            g = torch.where(gate, beta, zero)[:, None]
            fac_y = 1.0 - g * cy * x2
            fac_r = 1.0 - g * cr * x2
        elif method == "CW":
            phi = cf
            t = 1.0 + 2.0 * phi * margin
            inner = t * t - 8.0 * phi * (margin - phi * v)
            gamma = (-t + torch.sqrt(torch.clamp_min(inner, 0.0))) / (
                4.0 * phi * torch.clamp_min(v, 1e-12))
            alpha = torch.where(ok, torch.clamp_min(gamma, 0.0), zero)
            dy = alpha[:, None] * cy * values
            dr = -alpha[:, None] * cr * values
            a2 = 2.0 * alpha[:, None] * phi * x2
            fac_y = 1.0 / (1.0 + a2 * cy)
            fac_r = 1.0 / (1.0 + a2 * cr)
        else:  # NHERD
            gate = ok & (margin < 1.0)
            alpha = torch.where(gate, torch.clamp_min(1.0 - margin, 0.0)
                                / (v + cf), zero)
            dy = alpha[:, None] * cy * values
            dr = -alpha[:, None] * cr * values
            denom = 1.0 + torch.where(gate, 1.0, 0.0)[:, None] * (
                2.0 * cf + cf * cf * v[:, None]) * x2
            fac_y = 1.0 / denom
            fac_r = 1.0 / denom

    rows = torch.cat([lab, r])[:, None]                      # [2B, 1]
    idx2 = torch.cat([idx, idx], dim=0)                      # [2B, K]
    upd = torch.cat([dy, dr], dim=0)
    w.index_put_((rows.expand_as(idx2), idx2), upd, accumulate=True)
    if fac_y is not None:
        fac = torch.clamp_min(torch.cat([fac_y, fac_r], dim=0), 1e-6)
        flat = (rows * cov.shape[1] + idx2).reshape(-1)
        cov.view(-1).scatter_reduce_(0, flat, fac.reshape(-1), "prod")


def _centroid_train(sums, counts, active, indices, values, labels,
                    mask) -> None:
    """cosine/euclidean keep per-label sums; one batch scatter, in place."""
    idx = indices.long()
    lab = labels.long()
    sums.index_put_((lab[:, None].expand_as(idx), idx),
                    values * mask[:, None], accumulate=True)
    counts.index_add_(0, lab, mask.to(torch.int32))
    active |= counts > 0


def _classify_scores(w, active, indices, values) -> torch.Tensor:
    s = batch_scores(w, indices.long(), values)              # [B, L]
    return torch.where(active[None, :], s, float("-inf"))


def _centroid_scores(sums, counts, active, indices, values,
                     kind: str) -> torch.Tensor:
    cnt = torch.clamp_min(counts, 1).to(torch.float32)[:, None]
    cents = sums / cnt                                       # [L, D] means
    dots = batch_scores(cents, indices.long(), values)       # [B, L]
    if kind == "cosine":
        xn = torch.sqrt((values * values).sum(dim=-1, keepdim=True))
        cn = torch.sqrt((cents * cents).sum(dim=-1))[None, :]
        s = dots / torch.clamp_min(xn * cn, 1e-12)
    else:  # euclidean: -||x - c||  (monotone in similarity)
        x2 = (values * values).sum(dim=-1, keepdim=True)
        c2 = (cents * cents).sum(dim=-1)[None, :]
        s = -torch.sqrt(torch.clamp_min(x2 + c2 - 2.0 * dots, 0.0))
    return torch.where(active[None, :], s, float("-inf"))


def _pack_batch(indices, values, per_row, mask,
                per_row_dtype=np.int32) -> np.ndarray:
    """Host-side fuse of one converted batch into one blob
    [idx | val | labels | mask] (little-endian); the device step views it
    zero-copy after a single host->device transfer."""
    b, k = indices.shape
    nb = b * k * 4
    packed = np.empty(2 * nb + 8 * b, np.uint8)
    packed[:nb] = np.ascontiguousarray(indices, np.int32) \
        .reshape(-1).view(np.uint8)
    packed[nb:2 * nb] = np.ascontiguousarray(values, np.float32) \
        .reshape(-1).view(np.uint8)
    packed[2 * nb:2 * nb + 4 * b] = \
        np.ascontiguousarray(per_row, per_row_dtype) \
        .reshape(-1).view(np.uint8)
    packed[2 * nb + 4 * b:] = np.ascontiguousarray(mask, np.float32) \
        .reshape(-1).view(np.uint8)
    return packed


def _unpack_batch(buf: torch.Tensor, b: int, k: int):
    """Zero-copy views of a device-resident _pack_batch blob."""
    nb = b * k * 4
    idx = buf[:nb].view(torch.int32).view(b, k)
    val = buf[nb:2 * nb].view(torch.float32).view(b, k)
    lbl = buf[2 * nb:2 * nb + 4 * b].view(torch.int32)
    msk = buf[2 * nb + 4 * b:].view(torch.float32)
    return idx, val, lbl, msk


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@register_driver("classifier")
class ClassifierDriver(Driver):
    INITIAL_CAPACITY = 8

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.method = config.get("method", "AROW")
        if self.method not in MARGIN_METHODS + CENTROID_METHODS:
            raise ValueError(f"unknown classifier method: {self.method}")
        param = config.get("parameter") or {}
        self.c = float(param.get("regularization_weight", 1.0))
        if self.c <= 0:
            raise ValueError("regularization_weight must be > 0")
        self.batch_mode = param.get("microbatch", "sequential")
        if self.batch_mode not in ("sequential", "parallel"):
            raise ValueError(f"unknown microbatch mode: {self.batch_mode}")
        self.converter = DatumToFVConverter(
            ConverterConfig.from_json(config.get("converter")))
        self.dim = self.converter.dim
        self.labels: Dict[str, int] = {}          # label -> row
        self._free_rows: List[int] = []           # rows orphaned by delete_label
        self.capacity = self.INITIAL_CAPACITY
        self._alloc()
        # mix bookkeeping (host numpy, as in the JAX driver)
        self._updates_since_mix = 0
        self._w_base: Optional[np.ndarray] = None
        self._cov_base: Optional[np.ndarray] = None
        self._counts_base: Optional[np.ndarray] = None
        # columns touched since the last confirmed round (col-sparse diffs)
        self._touched_cols = np.zeros((self.dim,), bool)
        self._unconfirmed_cols: Optional[np.ndarray] = None
        self.dcn_payload = param.get("dcn_payload", "f32")
        if self.dcn_payload not in ("f32", "int8"):
            raise ValueError(f"unknown dcn_payload: {self.dcn_payload}")

    @property
    def _is_centroid(self) -> bool:
        return self.method in CENTROID_METHODS

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    def _alloc(self):
        l, d, dev = self.capacity, self.dim, self.device
        self.w = torch.zeros((l, d), dtype=torch.float32, device=dev)
        self.cov = (torch.ones((l, d), dtype=torch.float32, device=dev)
                    if _has_cov(self.method)
                    else torch.zeros((1, 1), dtype=torch.float32, device=dev))
        self.counts = torch.zeros((l,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((l,), dtype=torch.bool, device=dev)

    def _grow(self, need: int):
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self.capacity

        def grow(t, fill):
            extra = torch.full((pad,) + tuple(t.shape[1:]), fill,
                               dtype=t.dtype, device=t.device)
            return torch.cat([t, extra])

        self.w = grow(self.w, 0.0)
        if _has_cov(self.method):
            self.cov = grow(self.cov, 1.0)
        self.counts = grow(self.counts, 0)
        self.active = grow(self.active, False)
        if self._w_base is not None:
            self._w_base = np.pad(self._w_base, ((0, pad), (0, 0)))
            self._counts_base = np.pad(self._counts_base, (0, pad))
            if self._cov_base is not None:
                self._cov_base = np.pad(self._cov_base, ((0, pad), (0, 0)),
                                        constant_values=1.0)
        self.capacity = new_cap

    def _label_row(self, label: str) -> int:
        row = self.labels.get(label)
        if row is None:
            if self._free_rows:
                row = self._free_rows.pop()  # deleted rows already zeroed
            else:
                row = max(self.labels.values(), default=-1) + 1
                if row >= self.capacity:
                    self._grow(row + 1)
            self.labels[label] = row
        return row

    # -- RPC surface (classifier.idl) --------------------------------------

    def train(self, data: Sequence[Tuple[str, Datum]]) -> int:
        if not data:
            return 0
        rows = [self._label_row(lbl) for lbl, _ in data]
        batch = self.converter.convert_batch(
            [d for _, d in data], update_weights=True).pad_to(_round_b(len(data)))
        b = batch.indices.shape[0]
        labels = np.zeros((b,), np.int32)
        labels[: len(rows)] = rows
        mask = np.zeros((b,), np.float32)
        mask[: len(rows)] = 1.0
        self._dispatch_converted(batch.indices, batch.values, labels, mask,
                                 len(data))
        return len(data)

    def _mark_touched(self, indices) -> None:
        """Record the hashed feature columns a batch touches (col-sparse
        diffs).  Padding zeros mark column 0 — one extra diff column."""
        self._touched_cols[np.asarray(indices).reshape(-1)] = True

    def _dispatch_converted(self, indices, values, labels, mask,
                            n: int) -> None:
        """One device step over a converted batch: one host->device copy
        of the packed blob, then the train kernel over its views."""
        self._mark_touched(indices)
        b, k = np.asarray(indices).shape
        buf = torch.from_numpy(_pack_batch(indices, values, labels, mask)
                               ).to(self.device)
        idx, val, lbl, msk = _unpack_batch(buf, b, k)
        if self._is_centroid:
            _centroid_train(self.w, self.counts, self.active, idx, val, lbl,
                            msk)
        else:
            step = train_parallel if self.batch_mode == "parallel" \
                else train_scan
            step(self.w, self.cov, self.counts, self.active, idx, val, lbl,
                 msk, self.method, self.c)
        self._updates_since_mix += n

    def classify(self, data: Sequence[Datum]) -> List[List[Tuple[str, float]]]:
        if not data:
            return []
        batch = self.converter.convert_batch(list(data)).pad_to(_round_b(len(data)))
        idx = torch.from_numpy(batch.indices).to(self.device)
        val = torch.from_numpy(batch.values).to(self.device)
        if self._is_centroid:
            s = _centroid_scores(self.w, self.counts, self.active, idx, val,
                                 kind=self.method)
        else:
            s = _classify_scores(self.w, self.active, idx, val)
        s = s.cpu().numpy()
        label_rows = list(self.labels.items())
        out: List[List[Tuple[str, float]]] = []
        for i in range(len(data)):
            row = []
            for label, r in label_rows:
                if r >= s.shape[1]:
                    continue
                sc = float(s[i, r])
                row.append((label, sc if np.isfinite(sc) else 0.0))
            out.append(row)
        return out

    def classify_many(self, groups: Sequence[Sequence[Datum]]
                      ) -> List[List[List[Tuple[str, float]]]]:
        """N classify requests as one device sweep, demuxed per request."""
        flat = [d for g in groups for d in g]
        return split_groups(self.classify(flat), groups)

    def get_labels(self) -> Dict[str, int]:
        counts = self.counts.cpu().numpy()
        return {lbl: int(counts[r]) if r < counts.shape[0] else 0
                for lbl, r in list(self.labels.items())}

    def set_label(self, label: str) -> bool:
        if label in self.labels:
            return False
        row = self._label_row(label)
        self.active[row] = True
        return True

    def delete_label(self, label: str) -> bool:
        row = self.labels.pop(label, None)
        if row is None:
            return False
        self.w[row] = 0.0
        if _has_cov(self.method):
            self.cov[row] = 1.0
        self.counts[row] = 0
        self.active[row] = False
        # clear mix-base snapshots too, or the next label reusing this row
        # would emit a diff contaminated by the deleted label's base
        if self._w_base is not None:
            self._w_base[row] = 0.0
            self._counts_base[row] = 0
            if self._cov_base is not None:
                self._cov_base[row] = 1.0
        self._free_rows.append(row)
        return True

    def clear(self) -> None:
        self._touched_cols[:] = False
        self._unconfirmed_cols = None
        self.labels.clear()
        self._free_rows = []
        self.capacity = self.INITIAL_CAPACITY
        self._alloc()
        self.converter.weights.clear()
        self._updates_since_mix = 0
        self._w_base = None
        self._cov_base = None
        self._counts_base = None

    # -- MIX (linear mixable) ----------------------------------------------

    def _ensure_base(self):
        if self._w_base is None:
            self._w_base = np.zeros((self.capacity, self.dim), np.float32)
            self._counts_base = np.zeros((self.capacity,), np.int32)
            if _has_cov(self.method):
                self._cov_base = np.ones((self.capacity, self.dim), np.float32)

    def _gather(self, t: torch.Tensor, rows: np.ndarray,
                cols: np.ndarray) -> np.ndarray:
        """t[rows x cols] as a host array: one device gather + readback."""
        ri = torch.from_numpy(rows).to(self.device)[:, None]
        ci = torch.from_numpy(cols.astype(np.int64)).to(self.device)[None, :]
        return t[ri, ci].cpu().numpy()

    def _scatter(self, t: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray) -> None:
        ri = torch.from_numpy(rows).to(self.device)[:, None]
        ci = torch.from_numpy(cols.astype(np.int64)).to(self.device)[None, :]
        t[ri, ci] = torch.from_numpy(np.ascontiguousarray(vals, np.float32)
                                     ).to(self.device)

    def get_diff(self) -> Dict[str, Any]:
        """Column-sparse diff: only features touched since the last
        confirmed round ship — O(touched), not O(L x D)."""
        self._ensure_base()
        J = self._harvest_touched_cols()
        label_rows = {l: r for l, r in list(self.labels.items())
                      if r < self.capacity}
        labels = sorted(label_rows, key=label_rows.get)
        rows = np.array([label_rows[l] for l in labels], np.int64)
        counts = self.counts.cpu().numpy()
        diff = {
            "labels": labels,
            "dim": self.dim,
            "cols": J,
            "counts": counts[rows] - self._counts_base[rows],
            "k": 1,
            "weights": self.converter.weights.get_diff(),
        }
        if len(rows) and J.size:
            diff["w"] = self._gather(self.w, rows, J) - \
                self._w_base[np.ix_(rows, J)]
            if _has_cov(self.method):
                diff["cov"] = self._gather(self.cov, rows, J) - \
                    self._cov_base[np.ix_(rows, J)]
        else:
            diff["w"] = np.zeros((len(rows), J.size), np.float32)
            if _has_cov(self.method):
                diff["cov"] = np.zeros((len(rows), J.size), np.float32)
        return diff

    def encode_diff(self, diff: Dict[str, Any]) -> Dict[str, Any]:
        """Optional per-row int8 transport quantization
        ({"dcn_payload": "int8"})."""
        return self._quantize_diff_payload(diff)

    @staticmethod
    def _to_dense_diff(side: Dict[str, Any]) -> Dict[str, Any]:
        """Promote a col-sparse diff to full width."""
        cols = side.get("cols")
        if cols is None:
            return side
        d = int(side["dim"])
        out = dict(side)
        cols = np.asarray(cols, np.int64)
        for name in ("w", "cov"):
            if name in side:
                full = np.zeros((len(side["labels"]), d), np.float32)
                if cols.size and len(side["labels"]):
                    full[:, cols] = np.asarray(side[name], np.float32)
                out[name] = full
        out["cols"] = None
        return out

    @classmethod
    def mix(cls, lhs: Dict[str, Any], rhs: Dict[str, Any]) -> Dict[str, Any]:
        both_sparse = lhs.get("cols") is not None and rhs.get("cols") is not None
        if not both_sparse:
            lhs, rhs = cls._to_dense_diff(lhs), cls._to_dense_diff(rhs)
        labels = list(dict.fromkeys(list(lhs["labels"]) + list(rhs["labels"])))
        li = {l: i for i, l in enumerate(lhs["labels"])}
        ri = {l: i for i, l in enumerate(rhs["labels"])}

        if both_sparse:
            lc = np.asarray(lhs["cols"], np.int64)
            rc = np.asarray(rhs["cols"], np.int64)
            cols = np.union1d(lc, rc)
            lpos = np.searchsorted(cols, lc)
            rpos = np.searchsorted(cols, rc)
            m = cols.size

            def blk(side, idx_map, name, pos):
                out = np.zeros((len(labels), m), np.float32)
                src = np.asarray(side.get(name,
                                          np.zeros((0, 0))), np.float32)
                if name not in side or not src.size:
                    return out
                for j, l in enumerate(labels):
                    if l in idx_map:
                        out[j, pos] = src[idx_map[l]]
                return out

            out = {
                "labels": labels,
                "dim": int(lhs["dim"]),
                "cols": cols.astype(np.int32),
                "w": blk(lhs, li, "w", lpos) + blk(rhs, ri, "w", rpos),
            }
            if "cov" in lhs or "cov" in rhs:
                out["cov"] = blk(lhs, li, "cov", lpos) + \
                    blk(rhs, ri, "cov", rpos)
        else:
            d = lhs["w"].shape[1] if len(lhs["labels"]) else rhs["w"].shape[1]

            def take(side, idx_map, name, l):
                if l in idx_map:
                    return side[name][idx_map[l]]
                return np.zeros((d,), np.float32)

            w = np.stack([take(lhs, li, "w", l) + take(rhs, ri, "w", l)
                          for l in labels]) \
                if labels else np.zeros((0, d), np.float32)
            out = {"labels": labels, "cols": None, "w": w}
            if "dim" in lhs or "dim" in rhs:
                out["dim"] = int(lhs.get("dim") or rhs.get("dim"))
            if "cov" in lhs or "cov" in rhs:
                out["cov"] = np.stack([
                    (lhs["cov"][li[l]] if l in li and "cov" in lhs
                     else np.zeros(d, np.float32)) +
                    (rhs["cov"][ri[l]] if l in ri and "cov" in rhs
                     else np.zeros(d, np.float32))
                    for l in labels]) if labels else np.zeros((0, d),
                                                              np.float32)

        def cnt(side, idx_map, l):
            return int(side["counts"][idx_map[l]]) if l in idx_map else 0

        out["counts"] = np.array([cnt(lhs, li, l) + cnt(rhs, ri, l)
                                  for l in labels], np.int32)
        out["k"] = lhs["k"] + rhs["k"]
        out["weights"] = WeightManager.mix(lhs["weights"], rhs["weights"])
        return out

    def put_diff(self, diff: Dict[str, Any]) -> bool:
        self._ensure_base()
        k = max(int(diff["k"]), 1)
        labels = [l if isinstance(l, str) else l.decode()
                  for l in diff["labels"]]
        rows = np.array([self._label_row(l) for l in labels], np.int64)
        cols = diff.get("cols")
        for i, row in enumerate(rows):
            new_c = self._counts_base[row] + int(diff["counts"][i])
            self.counts[row] = int(new_c)
            self._counts_base[row] = new_c
            self.active[row] = True
        has_cov = "cov" in diff and _has_cov(self.method)
        if cols is None:
            for i, row in enumerate(rows):
                new_w = self._w_base[row] + np.asarray(diff["w"][i]) / k
                self.w[row] = torch.from_numpy(
                    np.ascontiguousarray(new_w, np.float32)).to(self.device)
                self._w_base[row] = new_w
                if has_cov:
                    new_cov = self._cov_base[row] + \
                        np.asarray(diff["cov"][i]) / k
                    self.cov[row] = torch.from_numpy(
                        np.ascontiguousarray(new_cov, np.float32)
                    ).to(self.device)
                    self._cov_base[row] = new_cov
        elif len(rows):
            J = np.asarray(cols, np.int64)
            if J.size:
                new_w = self._w_base[np.ix_(rows, J)] + \
                    np.asarray(diff["w"], np.float32) / k
                self._scatter(self.w, rows, J, new_w)
                self._w_base[np.ix_(rows, J)] = new_w
                if has_cov:
                    new_cov = self._cov_base[np.ix_(rows, J)] + \
                        np.asarray(diff["cov"], np.float32) / k
                    self._scatter(self.cov, rows, J, new_cov)
                    self._cov_base[np.ix_(rows, J)] = new_cov
        self.converter.weights.put_diff(diff["weights"])
        self._updates_since_mix = 0
        self._retire_confirmed_cols(cols)
        return True

    # -- persistence --------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        """The JAX driver's pack() layout, so model files cross packages."""
        obj = {
            "method": self.method,
            "labels": dict(self.labels),
            "capacity": self.capacity,
            "dim": self.dim,
            "w": self.w.cpu().numpy().tobytes(),
            "counts": self.counts.cpu().numpy().tobytes(),
            "active": self.active.cpu().numpy().tobytes(),
            "weights": self.converter.weights.pack(),
        }
        if _has_cov(self.method):
            obj["cov"] = self.cov.cpu().numpy().tobytes()
        return obj

    def unpack(self, obj: Dict[str, Any]) -> None:
        self.labels = {k if isinstance(k, str) else k.decode(): int(v)
                       for k, v in obj["labels"].items()}
        self.capacity = int(obj["capacity"])
        used = set(self.labels.values())
        top = max(used, default=-1)
        self._free_rows = [r for r in range(top) if r not in used]
        l, d = self.capacity, self.dim
        self.w = self._tensor(np.frombuffer(obj["w"], np.float32).reshape(l, d))
        self.counts = self._tensor(np.frombuffer(obj["counts"], np.int32))
        self.active = self._tensor(np.frombuffer(obj["active"], bool))
        if _has_cov(self.method) and "cov" in obj:
            self.cov = self._tensor(
                np.frombuffer(obj["cov"], np.float32).reshape(l, d))
        self.converter.weights.unpack(obj["weights"])
        self._w_base = None
        self._cov_base = None
        self._counts_base = None

    def get_status(self) -> Dict[str, str]:
        return {
            "num_classes": str(len(self.labels)),
            "num_features": str(self.dim),
            "method": self.method,
        }
