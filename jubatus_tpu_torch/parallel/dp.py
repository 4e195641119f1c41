"""Data-parallel classifier and regression on one torch device
(counterpart of jubatus_tpu/parallel/dp.py).

The JAX package stacks ndp model replicas [ndp, L, D] over its mesh's dp
axis: each dp slot is one "virtual server" that trains its own slice of
every microbatch, and the MIX round collapses into one all-reduce of
(replica - base) with a base reset.  The port keeps the ndp replicas
stacked on one card (parallel/mesh.py):

  * train: replica r scans rows [r * b/ndp, (r + 1) * b/ndp) of the
    batch, padded up to a multiple of ndp.  "sequential": ONE launch of
    the scans' replica grid (csrc/train_scan.cu, csrc/regression_scan.cu),
    a block a replica; "parallel": train_parallel on each replica's slice;
  * device_mix: the collective fold of parallel/collective.py, the exact
    f32 sum or the int8 ring on csrc/quantize.cu ({"mix_payload":
    "int8"}), run by mix/collective.py's CollectiveMixer or the linear
    mixer's _device_fold;
  * classify / estimate: datum i is answered by the replica whose slice
    holds it (the analog of proxy random routing);
  * the cross-process mixable API (get_diff, put_diff) and pack / unpack
    work on replica 0 after a device_mix, exactly as in the JAX package,
    so a DP server nests both MIX levels and its model files are a plain
    driver's.

The port's scans update state in place, so the device bases w_dbase,
cov_dbase and counts_dbase are tensors of their own, not aliases of the
state as in the JAX package; every write that the JAX driver applies to
the aliased pair is applied to both here.

DPClusteringDriver (:690 there) comes with the clustering engine (ROADMAP
Queue 1 item 7.1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.batching.arenas import arena_to_device
from jubatus_tpu_torch.batching.bucketing import round_b
from jubatus_tpu_torch.device import device_context
from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.models.classifier import (
    ClassifierDriver, _classify_scores, _has_cov, _pack_batch,
    _unpack_batch, train_parallel, train_scan_grid)
from jubatus_tpu_torch.models.regression import RegressionDriver
from jubatus_tpu_torch.models.regression import \
    train_scan_grid as reg_train_scan_grid
from jubatus_tpu_torch.ops.sparse import row_scores
from jubatus_tpu_torch.parallel.collective import make_tree_mix
from jubatus_tpu_torch.parallel.mesh import Mesh


def repad_raw(arrs, b: int, mult: int):
    """Pad the batch axis of each array from b up to a multiple of mult
    (jubatus_tpu/models/classifier.py _repad_raw): zero rows, masked."""
    bp = ((b + mult - 1) // mult) * mult
    if bp == b:
        return list(arrs)
    return [np.pad(a, ((0, bp - b),) + ((0, 0),) * (a.ndim - 1))
            for a in arrs]


def _arena_views(packed, b: int, k: int, per_row_dtype):
    """Host views of a _pack_batch arena: indices, values, per-row lane,
    mask."""
    nb = b * k * 4
    return (np.frombuffer(packed, np.int32, count=b * k).reshape(b, k),
            np.frombuffer(packed, np.float32, count=b * k,
                          offset=nb).reshape(b, k),
            np.frombuffer(packed, per_row_dtype, count=b, offset=2 * nb),
            np.frombuffer(packed, np.float32, count=b, offset=2 * nb + 4 * b))


class _StackedMixin:
    """Shared stacked-state helpers: replication, the batch's padding to
    the replica count, the stacked copy of a packed batch."""

    mesh: Mesh
    ndp: int
    device: torch.device

    def _replicate(self, host: np.ndarray) -> torch.Tensor:
        """Host [L, ...] -> device [ndp, L, ...]: one host->device copy,
        the replicas broadcast on the device."""
        t = torch.from_numpy(np.array(host)).to(self.device)
        return t.unsqueeze(0).expand((self.ndp,) + tuple(t.shape)).clone()

    def _pad_b(self, n: int) -> int:
        """Bucketed batch size, rounded up to divide the replicas."""
        b = max(round_b(n), self.ndp)
        return ((b + self.ndp - 1) // self.ndp) * self.ndp

    def _stacked_batch(self, indices, values, per_row, mask, packed,
                       per_row_dtype):
        """(host indices, device idx, val, per_row, mask views) of a batch
        padded to a multiple of ndp.  A packed arena (already in
        _pack_batch layout) is copied as it is when its rows divide;
        otherwise the views are re-padded and re-packed."""
        b, k = np.asarray(indices).shape
        if values is None:
            indices, values, per_row, mask = _arena_views(
                packed, b, k, per_row_dtype)
        if b % self.ndp:
            indices, values, per_row, mask = repad_raw(
                [indices, values, per_row, mask], b, self.ndp)
            b = indices.shape[0]
            packed = None
        if packed is None:
            packed = _pack_batch(indices, values, per_row, mask,
                                 per_row_dtype=per_row_dtype)
        buf = arena_to_device(packed, 2 * b * k * 4 + 8 * b, self.device)
        torch_dtype = torch.int32 if per_row_dtype == np.int32 \
            else torch.float32
        return (indices,) + tuple(_unpack_batch(buf, b, k, torch_dtype))

    def _slices(self, b: int) -> List[slice]:
        per = b // self.ndp
        return [slice(r * per, (r + 1) * per) for r in range(self.ndp)]


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

class DPClassifierDriver(_StackedMixin, ClassifierDriver):
    """ClassifierDriver with ndp replicas stacked on one device (margin
    methods only)."""

    def __init__(self, config: Dict[str, Any], mesh: Mesh):
        self.mesh = mesh
        self.ndp = mesh.ndp
        # "int8": the in-process int8 ring (parallel/quantized.py)
        self.mix_payload = (config.get("parameter") or {}).get(
            "mix_payload", "f32")
        self._tree_mix = make_tree_mix(self.ndp, self.mix_payload)
        super().__init__(config, device=mesh.device)
        if self._is_centroid:
            raise ValueError("DP wrapper supports margin methods only (for "
                             "now)")
        self.updates_since_device_mix = 0

    # -- stacked allocation ----------------------------------------------------

    def _alloc(self):
        n, l, d, dev = self.ndp, self.capacity, self.dim, self.device
        self.w = torch.zeros((n, l, d), dtype=torch.float32, device=dev)
        self.cov = (torch.ones((n, l, d), dtype=torch.float32, device=dev)
                    if _has_cov(self.method)
                    else torch.zeros((n, 1, 1), dtype=torch.float32,
                                     device=dev))
        self.counts = torch.zeros((n, l), dtype=torch.int32, device=dev)
        self.active = torch.zeros((n, l), dtype=torch.bool, device=dev)
        # the device-resident mix bases (the in-process fold's)
        self.w_dbase = self.w.clone()
        self.cov_dbase = self.cov.clone()
        self.counts_dbase = self.counts.clone()

    def _grow(self, need: int):
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self.capacity

        def grow(t, fill):
            extra = torch.full((t.shape[0], pad) + tuple(t.shape[2:]), fill,
                               dtype=t.dtype, device=t.device)
            return torch.cat([t, extra], dim=1)

        self.w = grow(self.w, 0.0)
        self.w_dbase = grow(self.w_dbase, 0.0)
        if _has_cov(self.method):
            self.cov = grow(self.cov, 1.0)
            self.cov_dbase = grow(self.cov_dbase, 1.0)
        self.counts = grow(self.counts, 0)
        self.counts_dbase = grow(self.counts_dbase, 0)
        self.active = grow(self.active, False)
        if self._w_base is not None:
            self._w_base = np.pad(self._w_base, ((0, pad), (0, 0)))
            self._counts_base = np.pad(self._counts_base, (0, pad))
            if self._cov_base is not None:
                self._cov_base = np.pad(self._cov_base, ((0, pad), (0, 0)),
                                        constant_values=1.0)
        self.capacity = new_cap

    # -- hot path ----------------------------------------------------------------

    def train(self, data: Sequence[Tuple[str, Datum]]) -> int:
        if not data:
            return 0
        rows = [self._label_row(lbl) for lbl, _ in data]
        b = self._pad_b(len(data))
        batch = self.converter.convert_batch(
            [d for _, d in data], update_weights=True).pad_to(b)
        labels = np.zeros((b,), np.int32)
        labels[: len(rows)] = rows
        mask = np.zeros((b,), np.float32)
        mask[: len(rows)] = 1.0
        self._dispatch_converted(batch.indices, batch.values, labels, mask,
                                 len(data))
        return len(data)

    def _dispatch_converted(self, indices, values, labels, mask, n: int,
                            packed=None) -> None:
        """Stage 2, DP variant (caller holds the model write lock): the
        batch re-padded to divide the replicas, one host->device copy,
        then ONE replica-grid launch ("sequential") or train_parallel on
        each replica's slice ("parallel")."""
        with device_context(self.device):
            host_idx, idx, val, lbl, msk = self._stacked_batch(
                indices, values, labels, mask, packed, np.int32)
            self._mark_touched(host_idx)      # col-sparse DCN diff tracking
            if self.batch_mode == "parallel":
                for r, rows in enumerate(self._slices(idx.shape[0])):
                    train_parallel(self.w[r], self.cov[r], self.counts[r],
                                   self.active[r], idx[rows], val[rows],
                                   lbl[rows], msk[rows], self.method, self.c)
            else:
                train_scan_grid(self.w, self.cov, self.counts, self.active,
                                idx, val, lbl, msk, self.method, self.c)
        self._updates_since_mix += n
        self.updates_since_device_mix += n

    def classify(self, data: Sequence[Datum]) -> List[List[Tuple[str, float]]]:
        if not data:
            return []
        batch = self.converter.convert_batch(list(data)).pad_to(
            self._pad_b(len(data)))
        idx = torch.from_numpy(batch.indices).to(self.device)
        val = torch.from_numpy(batch.values).to(self.device)
        s = torch.cat([_classify_scores(self.w[r], self.active[r], idx[rows],
                                        val[rows])
                       for r, rows in enumerate(self._slices(idx.shape[0]))])
        s = s.cpu().numpy()
        label_rows = list(self.labels.items())
        out: List[List[Tuple[str, float]]] = []
        for i in range(len(data)):
            row = []
            for label, r in label_rows:
                if r >= s.shape[1]:
                    continue          # interned by a stage-1 conversion
                sc = float(s[i, r])
                row.append((label, sc if np.isfinite(sc) else 0.0))
            out.append(row)
        return out

    # -- label ops (axis 0 is the replica axis) ----------------------------------

    def get_labels(self) -> Dict[str, int]:
        counts = self.counts[0].cpu().numpy()
        return {lbl: int(counts[r]) if r < counts.shape[0] else 0
                for lbl, r in list(self.labels.items())}

    def set_label(self, label: str) -> bool:
        if label in self.labels:
            return False
        row = self._label_row(label)
        self.active[:, row] = True
        return True

    def delete_label(self, label: str) -> bool:
        with self._label_mutex:
            row = self.labels.pop(label, None)
        if row is None:
            return False
        if row >= self.capacity:
            self._fast_rebuild()
            return True
        self.w[:, row] = 0.0
        self.w_dbase[:, row] = 0.0
        if _has_cov(self.method):
            self.cov[:, row] = 1.0
            self.cov_dbase[:, row] = 1.0
        self.counts[:, row] = 0
        self.counts_dbase[:, row] = 0
        self.active[:, row] = False
        if self._w_base is not None:
            self._w_base[row] = 0.0
            self._counts_base[row] = 0
            if self._cov_base is not None:
                self._cov_base[row] = 1.0
        with self._label_mutex:
            self._free_rows.append(row)
        self._fast_rebuild()
        return True

    # -- the in-process MIX ------------------------------------------------------

    def device_mix(self) -> None:
        """The collective fold: replicas <- base + mean(replica - base),
        counts <- base + sum(delta), active <- any(active)."""
        state = {"w": self.w, "counts": self.counts, "active": self.active}
        base = {"w": self.w_dbase, "counts": self.counts_dbase,
                "active": self.active}
        if _has_cov(self.method):
            state["cov"] = self.cov
            base["cov"] = self.cov_dbase
        with device_context(self.device):
            out = self._tree_mix(state, base)
            self.w, self.w_dbase = out["w"], out["w"].clone()
            self.counts, self.counts_dbase = (out["counts"],
                                              out["counts"].clone())
            self.active = out["active"]
            if _has_cov(self.method):
                self.cov, self.cov_dbase = out["cov"], out["cov"].clone()
        self.updates_since_device_mix = 0

    def collective_payload(self):
        """(payload, float_elems, exact_elems) a replica: the collective
        tier's byte estimate (mix/linear_mixer.py note_collective_bytes).
        The exact elements are the int/bool leaves (counts, active)."""
        l, d = self.capacity, self.dim
        float_elems = l * d * (2 if _has_cov(self.method) else 1)
        return self.mix_payload, float_elems, 2 * l

    # -- host-level views (cross-process MIX, persistence) -----------------------

    def _mix_tables(self):
        return self.w[0], self.cov[0], self.counts[0]

    def get_diff_snapshot(self) -> Dict[str, Any]:
        """The hierarchical MIX's level 1 first: fold the replicas, so the
        cross-process round ships ONE delta for the node (k stays 1), read
        from replica 0."""
        self.device_mix()
        return super().get_diff_snapshot()

    def _set_rows(self, pair, rows: torch.Tensor, vals: torch.Tensor):
        """Scatter label rows into every replica of each tensor of the
        pair (state and its device base)."""
        for t in pair:
            t[:, rows] = vals.unsqueeze(0)

    def _set_row_cols(self, pair, rows, cols, vals):
        """The col-sparse scatter: the [r, c] block at rows x cols of every
        replica; unshipped columns keep their local deltas."""
        for t in pair:
            t[:, rows[:, None], cols[None, :]] = vals.unsqueeze(0)

    def put_diff(self, diff: Dict[str, Any]) -> bool:
        # the ORIGINAL column set: only shipped columns retire, and only
        # they are scattered (a --mix_topk-dropped column keeps its delta)
        orig_cols = diff.get("cols")
        self._ensure_base()
        k = max(int(diff["k"]), 1)
        # fold any training since the last get_diff into every replica
        # first: the scatter below touches diff rows only
        self.device_mix()
        labels = [l if isinstance(l, str) else l.decode()
                  for l in diff["labels"]]
        # every label first, so _grow (and its _w_base resize) runs before
        # the scatters
        rows = [self._label_row(label) for label in labels]
        if rows:
            r = len(rows)
            has_cov = _has_cov(self.method) and "cov" in diff
            ncnt = np.empty((r,), np.int32)
            for i, row in enumerate(rows):
                ncnt[i] = self._counts_base[row] + int(diff["counts"][i])
                self._counts_base[row] = ncnt[i]
            dev = self.device
            ridx = torch.tensor(rows, dtype=torch.int64, device=dev)
            self._set_rows((self.counts, self.counts_dbase), ridx,
                           torch.from_numpy(ncnt).to(dev))
            self.active[:, ridx] = True
            if orig_cols is None:
                nw = np.empty((r, self.dim), np.float32)
                ncov = np.empty((r, self.dim), np.float32) if has_cov \
                    else None
                for i, row in enumerate(rows):
                    nw[i] = self._w_base[row] + diff["w"][i] / k
                    self._w_base[row] = nw[i]
                    if ncov is not None:
                        ncov[i] = self._cov_base[row] + diff["cov"][i] / k
                        self._cov_base[row] = ncov[i]
                self._set_rows((self.w, self.w_dbase), ridx,
                               torch.from_numpy(nw).to(dev))
                if ncov is not None:
                    self._set_rows((self.cov, self.cov_dbase), ridx,
                                   torch.from_numpy(ncov).to(dev))
            else:
                J = np.asarray(orig_cols, np.int64)
                if J.size:
                    rows_np = np.asarray(rows, np.int64)
                    cidx = torch.from_numpy(J).to(dev)
                    nw = self._w_base[np.ix_(rows_np, J)] + \
                        np.asarray(diff["w"], np.float32) / k
                    self._w_base[np.ix_(rows_np, J)] = nw
                    self._set_row_cols(
                        (self.w, self.w_dbase), ridx, cidx,
                        torch.from_numpy(np.ascontiguousarray(
                            nw, np.float32)).to(dev))
                    if has_cov:
                        ncov = self._cov_base[np.ix_(rows_np, J)] + \
                            np.asarray(diff["cov"], np.float32) / k
                        self._cov_base[np.ix_(rows_np, J)] = ncov
                        self._set_row_cols(
                            (self.cov, self.cov_dbase), ridx, cidx,
                            torch.from_numpy(np.ascontiguousarray(
                                ncov, np.float32)).to(dev))
        self.converter.weights.put_diff(diff["weights"])
        self._updates_since_mix = 0
        self._retire_confirmed_cols(orig_cols)
        return True

    def pack(self) -> Dict[str, Any]:
        self.device_mix()
        obj = {
            "method": self.method,
            "labels": dict(self.labels),
            "capacity": self.capacity,
            "dim": self.dim,
            "w": self.w[0].cpu().numpy().tobytes(),
            "counts": self.counts[0].cpu().numpy().tobytes(),
            "active": self.active[0].cpu().numpy().tobytes(),
            "weights": self.converter.weights.pack(),
        }
        if _has_cov(self.method):
            obj["cov"] = self.cov[0].cpu().numpy().tobytes()
        return obj

    def unpack(self, obj: Dict[str, Any]) -> None:
        self.labels = {k if isinstance(k, str) else k.decode(): int(v)
                       for k, v in obj["labels"].items()}
        self.capacity = int(obj["capacity"])
        used = set(self.labels.values())
        top = max(used, default=-1)
        self._free_rows = [r for r in range(top) if r not in used]
        l, d = self.capacity, self.dim
        self.w = self._replicate(
            np.frombuffer(obj["w"], np.float32).reshape(l, d))
        self.w_dbase = self.w.clone()
        self.counts = self._replicate(np.frombuffer(obj["counts"], np.int32))
        self.counts_dbase = self.counts.clone()
        self.active = self._replicate(np.frombuffer(obj["active"], bool))
        if _has_cov(self.method) and "cov" in obj:
            self.cov = self._replicate(
                np.frombuffer(obj["cov"], np.float32).reshape(l, d))
            self.cov_dbase = self.cov.clone()
        self.converter.weights.unpack(obj["weights"])
        self._w_base = None
        self._cov_base = None
        self._counts_base = None
        self._fast_rebuild()

    def get_status(self) -> Dict[str, str]:
        st = super().get_status()
        st["dp_replicas"] = str(self.ndp)
        st["updates_since_device_mix"] = str(self.updates_since_device_mix)
        return st


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------

class DPRegressionDriver(_StackedMixin, RegressionDriver):
    """RegressionDriver with ndp replicas of w stacked [ndp, D] on one
    device; each replica trains its slice of the microbatch, device_mix
    folds the deltas."""

    def __init__(self, config: Dict[str, Any], mesh: Mesh):
        self.mesh = mesh
        self.ndp = mesh.ndp
        self.mix_payload = (config.get("parameter") or {}).get(
            "mix_payload", "f32")
        self._tree_mix = make_tree_mix(self.ndp, self.mix_payload)
        super().__init__(config, device=mesh.device)
        self._alloc_stacked()
        self.updates_since_device_mix = 0

    def _alloc_stacked(self) -> None:
        self.w = torch.zeros((self.ndp, self.dim), dtype=torch.float32,
                             device=self.device)
        self.w_dbase = self.w.clone()

    def train(self, data: Sequence[Tuple[float, Datum]]) -> int:
        if not data:
            return 0
        b = self._pad_b(len(data))
        batch = self.converter.convert_batch(
            [d for _, d in data], update_weights=True).pad_to(b)
        targets = np.zeros((b,), np.float32)
        targets[: len(data)] = [t for t, _ in data]
        mask = np.zeros((b,), np.float32)
        mask[: len(data)] = 1.0
        self._dispatch_converted(batch.indices, batch.values, targets, mask,
                                 len(data))
        return len(data)

    def _dispatch_converted(self, indices, values, targets, mask, n: int,
                            packed=None) -> None:
        """Stage 2, DP variant: the batch re-padded to divide the
        replicas, one copy, ONE replica-grid launch."""
        with device_context(self.device):
            host_idx, idx, val, tgt, msk = self._stacked_batch(
                indices, values, targets, mask, packed, np.float32)
            self._touched_cols[np.asarray(host_idx).reshape(-1)] = True
            reg_train_scan_grid(self.w, idx, val, tgt, msk, self.method,
                                self.c, self.eps)
        self.num_trained += n
        self._updates_since_mix += n
        self.updates_since_device_mix += n

    def estimate(self, data: Sequence[Datum]) -> List[float]:
        if not data:
            return []
        b = self._pad_b(len(data))
        batch = self.converter.convert_batch(list(data)).pad_to(b)
        idx = torch.from_numpy(batch.indices).to(self.device).long()
        val = torch.from_numpy(batch.values).to(self.device)
        out = torch.cat([row_scores(self.w[r], idx[rows], val[rows])
                         for r, rows in enumerate(self._slices(b))])
        return [float(v) for v in out.cpu().numpy()[: len(data)]]

    def device_mix(self) -> None:
        with device_context(self.device):
            out = self._tree_mix({"w": self.w}, {"w": self.w_dbase})["w"]
            self.w, self.w_dbase = out, out.clone()
        self.updates_since_device_mix = 0

    def collective_payload(self):
        """(payload, float_elems, exact_elems) a replica (see
        DPClassifierDriver.collective_payload)."""
        return self.mix_payload, self.dim, 0

    def clear(self) -> None:
        super().clear()
        self._alloc_stacked()
        self.updates_since_device_mix = 0

    # -- host-level views (cross-process MIX, persistence) -----------------------

    def _mix_w(self) -> torch.Tensor:
        return self.w[0]

    def get_diff_snapshot(self) -> Dict[str, Any]:
        """Level 1 first (the replicas' fold), then replica 0's
        column-sparse delta for the node."""
        self.device_mix()
        return super().get_diff_snapshot()

    def put_diff(self, diff: Dict[str, Any]) -> bool:
        self._ensure_base()
        orig_cols = diff.get("cols")        # only shipped columns retire
        k = max(int(diff["k"]), 1)
        dev = self.device
        if orig_cols is None:
            new_w = self._w_base + np.asarray(diff["w"], np.float32) / k
            self.w = self._replicate(new_w)
            self.w_dbase = self.w.clone()
            self._w_base = new_w
        else:
            # reconcile the replicas FIRST (a base reset against divergent
            # replicas would freeze the divergence), then ONLY the shipped
            # columns: an unshipped column's local delta survives
            self.device_mix()
            J = np.asarray(orig_cols, np.int64)
            if J.size:
                new_vals = self._w_base[J] + \
                    np.asarray(diff["w"], np.float32).reshape(-1) / k
                self._w_base[J] = new_vals
                cidx = torch.from_numpy(J).to(dev)
                vals = torch.from_numpy(np.ascontiguousarray(
                    new_vals, np.float32)).to(dev)
                for t in (self.w, self.w_dbase):
                    t[:, cidx] = vals.unsqueeze(0)
        self.converter.weights.put_diff(diff["weights"])
        self._updates_since_mix = 0
        self._retire_confirmed_cols(orig_cols)
        return True

    def pack(self) -> Dict[str, Any]:
        self.device_mix()
        return {"method": self.method,
                "w": self.w[0].cpu().numpy().tobytes(),
                "num_trained": self.num_trained,
                "weights": self.converter.weights.pack()}

    def unpack(self, obj: Dict[str, Any]) -> None:
        w = np.frombuffer(obj["w"], np.float32)
        if w.shape != (self.dim,):
            raise ValueError(f"w of {w.size} floats does not match dim "
                             f"{self.dim}")
        self.w = self._replicate(w)
        self.w_dbase = self.w.clone()
        self.num_trained = int(obj["num_trained"])
        self.converter.weights.unpack(obj["weights"])
        self._w_base = None

    def get_status(self) -> Dict[str, str]:
        st = super().get_status()
        st["dp_replicas"] = str(self.ndp)
        st["updates_since_device_mix"] = str(self.updates_since_device_mix)
        return st


# ---------------------------------------------------------------------------
# factory: the server's --dp_replicas
# ---------------------------------------------------------------------------

DP_DRIVERS = {
    "classifier": DPClassifierDriver,
    "regression": DPRegressionDriver,
}


def create_dp_driver(service: str, config: Dict[str, Any], mesh: Mesh):
    """The data-parallel driver of `service` over `mesh`.  Raises
    ValueError for engines without one (clustering's comes with the
    engine, ROADMAP Queue 1 item 7.1; the row engines shard by key,
    item 6)."""
    if service == "clustering":
        raise ValueError("the data-parallel clustering driver is not in the "
                         "port yet: ROADMAP Queue 1 item 7.1")
    cls = DP_DRIVERS.get(service)
    if cls is None:
        raise ValueError(f"no data-parallel driver for service {service!r} "
                         f"(have {sorted(DP_DRIVERS)})")
    return cls(config, mesh)
