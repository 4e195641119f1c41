"""Online linear regression, passive-aggressive family, on one torch device
(counterpart of jubatus_tpu/models/regression.py).

Methods PA, PA1, PA2 over one [D] float32 weight vector in the hashed
feature space, with an epsilon-insensitive loss (`sensitivity`) and
`regularization_weight` C.  Train keeps the reference's strict per-datum
order: on CUDA it is ONE launch of the hand-written scan kernel
(csrc/regression_scan.cu, planned by reg_scan_plan) over the whole packed
batch; train_scan_ref is its plain PyTorch version, the JAX package's
train_scan_impl step for step.  Wire train frames [name, [[score,
datum], ...]] take the native raw path when the converter config is
eligible (fv/fast.py): the C FastConverter (mode 1) fills one packed
[idx | val | target | mask] arena per window, which reaches the device
in one copy (convert_raw_batch / train_converted_batch, driven by
framework/dispatch.IngestPipeline).  estimate is a gather-dot in torch
ops (ops/sparse.row_scores), as it is a plain XLA op in the JAX package.
w is updated in place.  float32 subnormals flush as under XLA, in the
kernel (-ftz=true) and in the plain version and the reads (ops.sparse.ftz).

MIX: get_diff exports (w - w_base) over the columns touched since the
last confirmed round; mix sums; put_diff applies the mean delta and
resnapshots the base — the JAX driver's host algebra.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.batching.arenas import ArenaPool, arena_to_device
from jubatus_tpu_torch.batching.bucketing import (B_BUCKETS,
                                                  fuse_sparse_batches,
                                                  round_b, split_groups)
from jubatus_tpu_torch.device import device_context, resolve_device
from jubatus_tpu_torch.fv import ConverterConfig, Datum, DatumToFVConverter
from jubatus_tpu_torch.fv.converter import _K_BUCKETS
from jubatus_tpu_torch.fv.fast import make_fast_converter
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.models.base import Driver, RawBatch, register_driver
from jubatus_tpu_torch.models.classifier import _pack_batch, _unpack_batch
from jubatus_tpu_torch.ops.sparse import ftz, row_scores

METHODS = ("PA", "PA1", "PA2")   # method ids of csrc/regression_scan.cu

# the converter's mode for [name, [[score, datum], ...]] (native/_fastconv.c)
_RAW_MODE = 1


# ---------------------------------------------------------------------------
# sequential train step: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: -1 and +1, and the argument itself for a signed zero or a
    NaN (torch.sign gives +0 for both)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def train_scan_ref(w, indices, values, targets, mask, method: str, c: float,
                   eps: float) -> None:
    """Plain PyTorch version of the scan kernel: sequential PA regression
    updates over one microbatch, in place; train_scan_impl of the JAX
    package expression by expression, in float32 (c and eps are float32
    scalars, as they are dynamic float32 arguments there).

    Subnormals are flushed as XLA flushes them (ops.sparse.ftz): the
    gathered w, the values, targets, mask, c and eps read as zero where
    subnormal, and every elementwise result flushes, the scatter-add's
    too (the touched columns of w are flushed before and after it).  The
    inner partial sums of the two reductions, and of a column's
    duplicate entries in the scatter-add, are not flushed one by one.

    w: [D] f32   indices/values: [B, K]   targets, mask: [B] f32
    """
    dev = w.device
    cf = ftz(torch.tensor(c, dtype=torch.float32, device=dev))
    ef = ftz(torch.tensor(eps, dtype=torch.float32, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    half_c = ftz(0.5 / cf)
    for i in range(indices.shape[0]):
        idx = indices[i].long()
        val = ftz(values[i])
        g = ftz(w[idx])
        pred = ftz(ftz(g * val).sum())
        err = ftz(ftz(targets[i]) - pred)
        loss = ftz(err.abs() - ef)
        sqn = ftz(ftz(val * val).sum())
        ok = (ftz(mask[i]) > 0) & (loss > 0) & (sqn > 0)
        if method == "PA":
            tau = ftz(loss / sqn)
        elif method == "PA1":
            tau = torch.minimum(cf, ftz(loss / sqn))
        else:  # PA2
            tau = ftz(loss / ftz(sqn + half_c))
        tau = torch.where(ok, tau, zero)
        upd = ftz(ftz(_sign(err) * tau) * val)
        w[idx] = g
        w.index_add_(0, idx, upd)
        w[idx] = ftz(w[idx])


# Launch plan of csrc/regression_scan.cu (struct Plan there): T datums a
# block, S block slots in the ring, P producer warps.
REG_BLOCK_ENTRIES = 1024  # entries a block aims at: T = this // K
REG_RING = 2              # ring depth S: the fastest measured (PERF.md)
REG_PRODUCERS = 6         # producer warps P: the fastest measured
REG_SMEM_LIMIT = 232448   # shared memory one block can opt into on sm_90


def _align16(x: int) -> int:
    return (x + 15) & ~15


def reg_scan_smem_bytes(t: int, s: int, k: int) -> int:
    """Shared-memory bytes of the scan kernel's layout (make_plan in
    csrc/regression_scan.cu): 3 barriers a slot, then S slots of a
    T-datum block: header, per-datum meta, the values, table numbers and
    group masks of T*K entries, a value table of T*K columns with their
    forwarding lists, and a column hash of at least 2*T*K (>= 32)
    entries."""
    nt = t * k
    hsize = max(32, 1 << (2 * nt - 1).bit_length())
    return _align16(24 * s) + s * _align16(16 + 16 * t + 28 * nt + 8 * hsize)


def reg_scan_plan(k: int) -> Tuple[int, int, int]:
    """(T, S, P) for a launch at K entries per datum: T =
    REG_BLOCK_ENTRIES // K (at least 1) datums a block, S = REG_RING slots
    and P = REG_PRODUCERS warps, cut to fit REG_SMEM_LIMIT bytes: T halved
    down to 1, then S down to 1.  Raises ValueError where not even one
    one-datum slot fits (the C entry refuses a ring or a producer count
    beyond its own limits)."""
    t = max(1, REG_BLOCK_ENTRIES // k)
    s = REG_RING
    while reg_scan_smem_bytes(t, s, k) > REG_SMEM_LIMIT:
        if t > 1:
            t //= 2
        elif s > 1:
            s -= 1
        else:
            raise ValueError(
                f"regression train_scan: K={k} entries per datum need "
                f"{reg_scan_smem_bytes(1, 1, k)} bytes of shared memory for "
                f"one one-datum slot; one block has {REG_SMEM_LIMIT}")
    return t, s, REG_PRODUCERS


def _scan_lib() -> ctypes.CDLL:
    lib = build.load("regression_scan")
    lib.regression_scan_grid_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.regression_scan_grid_launch.restype = ctypes.c_int
    lib.regression_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.regression_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch_grid(name, w, indices, values, targets, mask, method: str,
                 c: float, eps: float):
    """Checks stacked weights w [ndp, D] and a batch of ndp * B datums on
    one CUDA device, then makes ONE launch of csrc/regression_scan.cu's
    grid, ndp blocks, replica r on rows [r * B, (r + 1) * B), planned by
    reg_scan_plan (the plan depends on K, not on the datums a block).
    -> (plan, err), or None with no launch when B is 0.  Raises before
    launching on a bad tensor."""
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if method not in METHODS:
        raise ValueError(f"unknown regression method: {method}")
    if w.dim() != 2:
        raise ValueError(f"{name}: want w [ndp, D], got {tuple(w.shape)}")
    ndp, d = w.shape
    b, k = indices.shape
    if b % ndp:
        raise ValueError(f"{name}: B={b} datums do not split into {ndp} "
                         f"replicas")
    for t, dt in ((w, torch.float32), (indices, torch.int32),
                  (values, torch.float32), (targets, torch.float32),
                  (mask, torch.float32)):
        if t.dtype != dt or t.device != w.device or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} on {w.device}, "
                             f"got {t.dtype} on {t.device}")
    if tuple(values.shape) != (b, k) or tuple(targets.shape) != (b,) \
            or tuple(mask.shape) != (b,):
        raise ValueError(f"{name}: inconsistent batch/state shapes")
    per = b // ndp
    if (per + 1) * k >= 1 << 30:
        raise ValueError(f"{name}: B={per} x K={k} entries a replica is "
                         f"more than the kernel takes in one launch")
    if per == 0:
        return None                    # nothing to launch
    plan = reg_scan_plan(k)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _scan_lib().regression_scan_grid_launch(
        w.data_ptr(), indices.data_ptr(), values.data_ptr(),
        targets.data_ptr(), mask.data_ptr(), per, k, d, ndp,
        METHODS.index(method), float(c), float(eps), *plan, stream)
    return plan, err


def train_scan(w, indices, values, targets, mask, method: str, c: float,
               eps: float) -> None:
    """Sequential PA regression updates over one microbatch, in place.
    CUDA tensors: one launch of csrc/regression_scan.cu, the replica grid
    at one block (_launch_grid).  CPU tensors: the plain version.  Shapes
    as train_scan_ref; indices int32, each in [0, D) (the converter hashes
    into the model's width)."""
    if w.device.type == "cpu":
        train_scan_ref(w, indices, values, targets, mask, method, c, eps)
        return
    if w.dim() != 1:
        raise ValueError("train_scan: inconsistent batch/state shapes")
    launched = _launch_grid("train_scan", w.unsqueeze(0), indices, values,
                            targets, mask, method, c, eps)
    if launched is None:
        return
    train_scan.launches += 1
    train_scan.last_plan = launched[0]
    build.check(launched[1], "regression_scan launch")


train_scan.launches = 0
train_scan.last_plan = None


# ---------------------------------------------------------------------------
# the replica grid: ndp replicas' scans in one launch (parallel/dp.py)
# ---------------------------------------------------------------------------

def train_scan_grid_ref(w, indices, values, targets, mask, method: str,
                        c: float, eps: float) -> None:
    """Plain version of the replica grid: train_scan_ref of replica r
    (w[r], w: [ndp, D]) on rows [r * B/ndp, (r + 1) * B/ndp) of the batch,
    for each r in turn."""
    ndp = w.shape[0]
    per = indices.shape[0] // ndp
    for r in range(ndp):
        rows = slice(r * per, (r + 1) * per)
        train_scan_ref(w[r], indices[rows], values[rows], targets[rows],
                       mask[rows], method, c, eps)


def train_scan_grid(w, indices, values, targets, mask, method: str,
                    c: float, eps: float) -> None:
    """ndp replicas' sequential PA updates in place, replica r on its
    slice of the batch (the JAX package's shard_map of train_scan_impl
    over dp).  CUDA tensors: ONE launch of csrc/regression_scan.cu's
    replica grid (_launch_grid), counted apart from train_scan's.  CPU
    tensors: the plain version.  w: [ndp, D]; the batch as
    train_scan_ref's, B a multiple of ndp."""
    if w.device.type == "cpu":
        train_scan_grid_ref(w, indices, values, targets, mask, method, c,
                            eps)
        return
    launched = _launch_grid("train_scan_grid", w, indices, values, targets,
                            mask, method, c, eps)
    if launched is None:
        return
    train_scan_grid.launches += 1
    train_scan_grid.last_plan = launched[0] + (w.shape[0],)
    build.check(launched[1], "regression_scan_grid launch")


train_scan_grid.launches = 0
train_scan_grid.last_plan = None


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@register_driver("regression")
class RegressionDriver(Driver):

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.method = config.get("method", "PA")
        if self.method not in METHODS:
            raise ValueError(f"unknown regression method: {self.method}")
        param = config.get("parameter") or {}
        self.c = float(param.get("regularization_weight", 1.0))
        self.eps = float(param.get("sensitivity", 0.1))
        self.converter = DatumToFVConverter(
            ConverterConfig.from_json(config.get("converter")))
        self.dim = self.converter.dim
        # native wire converter (None when the config needs the Python
        # converter; fv/fast.py decides)
        self._fast = make_fast_converter(self.converter.config, _K_BUCKETS,
                                         B_BUCKETS)
        # recycled host arenas of the batched convert, pinned for cuda
        self.arena_pool = ArenaPool(pinned=self.device.type == "cuda")
        # serializes stage 1 of the raw train (framework/dispatch.py);
        # conversion is pure here (no label table), so no generation guard
        self.convert_lock = threading.Lock()
        self.w = torch.zeros((self.dim,), dtype=torch.float32,
                             device=self.device)
        self.num_trained = 0
        self._w_base: Optional[np.ndarray] = None
        self._updates_since_mix = 0
        # columns touched since the last confirmed round (col-sparse diffs)
        self._touched_cols = np.zeros((self.dim,), bool)
        self._unconfirmed_cols: Optional[np.ndarray] = None
        self.dcn_payload = param.get("dcn_payload", "f32")
        if self.dcn_payload not in ("f32", "int8"):
            raise ValueError(f"unknown dcn_payload: {self.dcn_payload}")

    # -- RPC surface (regression.idl) ---------------------------------------

    def train(self, data: Sequence[Tuple[float, Datum]]) -> int:
        if not data:
            return 0
        batch = self.converter.convert_batch(
            [d for _, d in data], update_weights=True).pad_to(round_b(len(data)))
        b = batch.indices.shape[0]
        targets = np.zeros((b,), np.float32)
        targets[: len(data)] = [t for t, _ in data]
        mask = np.zeros((b,), np.float32)
        mask[: len(data)] = 1.0
        # the same stage 2 as the raw path
        self._dispatch_converted(batch.indices, batch.values, targets, mask,
                                 len(data))
        return len(data)

    def _dispatch_converted(self, indices, values, targets, mask, n: int,
                            packed=None) -> None:
        """Stage 2 (caller holds the model write lock): one host->device
        copy of the packed blob, then the scan kernel over its views.
        `packed` (the native batched-convert arena, already in
        _pack_batch layout) skips the host re-pack."""
        self._touched_cols[np.asarray(indices).reshape(-1)] = True
        b, k = np.asarray(indices).shape
        if packed is None:
            packed = _pack_batch(indices, values, targets, mask,
                                 per_row_dtype=np.float32)
        with device_context(self.device):
            buf = arena_to_device(packed, 2 * b * k * 4 + 8 * b, self.device)
            idx, val, tgt, msk = _unpack_batch(buf, b, k, torch.float32)
            train_scan(self.w, idx, val, tgt, msk, self.method, self.c,
                       self.eps)
        self.num_trained += n
        self._updates_since_mix += n

    def convert_raw_request(self, msg: bytes, params_off: int):
        """Stage 1 of the per-frame raw train (caller holds convert_lock,
        not the model lock): native parse of [name, [[score, datum],
        ...]] into padded host buffers; None for an empty request."""
        n, b, k, scores, idx_b, val_b, _ = self._fast.convert(
            msg, params_off, _RAW_MODE)
        if n == 0:
            return None
        mask = np.zeros((b,), np.float32)
        mask[:n] = 1.0
        return (n, np.frombuffer(idx_b, np.int32).reshape(b, k),
                np.frombuffer(val_b, np.float32).reshape(b, k),
                np.frombuffer(scores, np.float32), mask)

    def train_converted(self, conv) -> int:
        if conv is None:
            return 0
        n, indices, values, targets, mask = conv
        self._dispatch_converted(indices, values, targets, mask, n)
        return n

    def train_raw(self, msg: bytes, params_off: int) -> int:
        """Wire fast path: one raw train request -> one device step (caller
        holds the model write lock)."""
        return self.train_converted(self.convert_raw_request(msg, params_off))

    def convert_raw_batch(self, frames) -> RawBatch:
        """Stage 1, fused: N raw train frames -> ONE packed arena from the
        driver's arena pool, in a single native call that releases the GIL
        (see ClassifierDriver.convert_raw_batch; no label table, so no
        generation guard or row patching)."""
        frames = list(frames)
        ns, b, k, arena, _ = self._fast.convert_raw_batch(
            frames, _RAW_MODE, self.arena_pool.acquire)
        return RawBatch(0, frames, list(ns), b, k, arena)

    def train_converted_batch(self, rb: RawBatch) -> List[int]:
        """Stage 2, fused (caller holds the model write lock): one device
        step for the whole converted window."""
        if rb.b == 0:
            return list(rb.ns)
        indices = np.frombuffer(rb.arena, np.int32,
                                count=rb.b * rb.k).reshape(rb.b, rb.k)
        self._dispatch_converted(indices, None, None, None, rb.total,
                                 packed=rb.arena)
        return list(rb.ns)

    def train_converted_many(self, convs) -> List[int]:
        """Several stage-1 conversions as ONE device step (exact: the scan
        over r1 || r2 is the scan over r1 and then r2; masked pad rows are
        no-ops)."""
        fresh = [c for c in convs if c is not None]
        if len(fresh) > 1:
            indices, values, targets, mask = fuse_sparse_batches(
                [c[1:] for c in fresh])
            self._dispatch_converted(indices, values, targets, mask,
                                     sum(c[0] for c in fresh))
            return [c[0] if c is not None else 0 for c in convs]
        return [self.train_converted(c) for c in convs]

    def estimate(self, data: Sequence[Datum]) -> List[float]:
        if not data:
            return []
        batch = self.converter.convert_batch(list(data)).pad_to(
            round_b(len(data)))
        idx = torch.from_numpy(batch.indices).to(self.device)
        val = torch.from_numpy(batch.values).to(self.device)
        out = row_scores(self.w, idx.long(), val).cpu().numpy()
        return [float(v) for v in out[: len(data)]]

    def estimate_many(self, groups: Sequence[Sequence[Datum]]
                      ) -> List[List[float]]:
        """N estimate requests as one device sweep, demuxed per request
        (each row's gather-dot does not depend on the batch axis)."""
        flat = [d for g in groups for d in g]
        return split_groups(self.estimate(flat), groups)

    def clear(self) -> None:
        self.w = torch.zeros((self.dim,), dtype=torch.float32,
                             device=self.device)
        self.num_trained = 0
        self.converter.weights.clear()
        self._w_base = None
        self._updates_since_mix = 0
        self._touched_cols[:] = False
        self._unconfirmed_cols = None

    # -- MIX (linear mixable) ----------------------------------------------

    def _ensure_base(self) -> None:
        if self._w_base is None:
            self._w_base = np.zeros((self.dim,), np.float32)

    def _cols(self, J: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(J.astype(np.int64)).to(self.device)

    def get_diff(self) -> Dict[str, Any]:
        """Column-sparse diff: only features touched since the last
        confirmed round ship."""
        return self._subtract_bases(self.get_diff_snapshot())

    def _mix_w(self) -> torch.Tensor:
        """The weights the diff is read from (a data-parallel driver's
        replica 0, parallel/dp.py)."""
        return self.w

    def get_diff_snapshot(self) -> Dict[str, Any]:
        """The part of get_diff taken under the model write lock: the
        harvest, one device gather of the touched columns to the host and
        a copy of their base; encode_diff subtracts it."""
        self._ensure_base()
        J = self._harvest_touched_cols()
        snap = {"cols": J, "dim": self.dim,
                "w": np.zeros((0,), np.float32)}
        if J.size:
            snap["w"] = self._mix_w()[self._cols(J)].cpu().numpy()
            snap["w_base"] = self._w_base[J]
        snap["k"] = 1
        snap["weights"] = self.converter.weights.get_diff()
        return snap

    def encode_diff(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Outside the lock: a snapshot's subtraction, the optional top-k
        column sparsification (--mix_topk), then the optional int8
        transport quantization ({"dcn_payload": "int8"})."""
        return self._quantize_diff_payload(
            self._sparsify_topk(self._subtract_bases(snap), keys=("w",)),
            keys=("w",))

    @staticmethod
    def _to_dense_w(side) -> np.ndarray:
        """A (possibly col-sparse) regression diff's w at full width."""
        if side.get("cols") is None:
            return np.asarray(side["w"], np.float32)
        full = np.zeros((int(side["dim"]),), np.float32)
        c = np.asarray(side["cols"], np.int64)
        if c.size:
            full[c] = np.asarray(side["w"], np.float32).reshape(-1)
        return full

    @classmethod
    def mix(cls, lhs: Dict[str, Any], rhs: Dict[str, Any]) -> Dict[str, Any]:
        lc, rc = lhs.get("cols"), rhs.get("cols")
        if lc is not None and rc is not None:
            lc = np.asarray(lc, np.int64)
            rc = np.asarray(rc, np.int64)
            cols = np.union1d(lc, rc)
            w = np.zeros((cols.size,), np.float32)
            if lc.size:
                w[np.searchsorted(cols, lc)] += \
                    np.asarray(lhs["w"], np.float32).reshape(-1)
            if rc.size:
                w[np.searchsorted(cols, rc)] += \
                    np.asarray(rhs["w"], np.float32).reshape(-1)
            out = {"cols": cols.astype(np.int32),
                   "dim": int(lhs["dim"]), "w": w}
        else:
            out = {"cols": None,
                   "w": cls._to_dense_w(lhs) + cls._to_dense_w(rhs)}
        out["k"] = lhs["k"] + rhs["k"]
        out["weights"] = WeightManager.mix(lhs["weights"], rhs["weights"])
        return out

    def put_diff(self, diff: Dict[str, Any]) -> bool:
        self._ensure_base()
        k = max(int(diff["k"]), 1)
        cols = diff.get("cols")
        if cols is None:
            new_w = self._w_base + np.asarray(diff["w"], np.float32) / k
            # a copy: w trains in place, the base must not move with it
            self.w = torch.tensor(new_w, dtype=torch.float32,
                                  device=self.device)
            self._w_base = new_w
        else:
            J = np.asarray(cols, np.int64)
            if J.size:
                new_w = self._w_base[J] + \
                    np.asarray(diff["w"], np.float32).reshape(-1) / k
                self.w[self._cols(J)] = torch.from_numpy(
                    np.ascontiguousarray(new_w, np.float32)).to(self.device)
                self._w_base[J] = new_w
        self.converter.weights.put_diff(diff["weights"])
        self._updates_since_mix = 0
        self._retire_confirmed_cols(cols)
        return True

    # -- persistence --------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        """The JAX driver's pack() layout, so model files cross packages."""
        return {"method": self.method, "w": self.w.cpu().numpy().tobytes(),
                "num_trained": self.num_trained,
                "weights": self.converter.weights.pack()}

    def unpack(self, obj: Dict[str, Any]) -> None:
        w = np.frombuffer(obj["w"], np.float32)
        if w.shape != (self.dim,):
            raise ValueError(f"w of {w.size} floats does not match dim "
                             f"{self.dim}")
        self.w = torch.from_numpy(w.copy()).to(self.device)
        self.num_trained = int(obj["num_trained"])
        self.converter.weights.unpack(obj["weights"])
        self._w_base = None

    def get_status(self) -> Dict[str, str]:
        return {"num_trained": str(self.num_trained), "method": self.method}
