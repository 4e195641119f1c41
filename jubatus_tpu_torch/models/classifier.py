"""Multi-class online linear classifiers on one torch device (counterpart
of jubatus_tpu/models/classifier.py).

Methods: perceptron, PA, PA1, PA2, CW, AROW, NHERD (margin methods, dense
[L, D] weight and diagonal-covariance tables over the hashed feature
space) and cosine, euclidean (per-label centroid sums).

Train is one device step per microbatch.  Wire train frames take the
native raw path when the converter config is eligible (fv/fast.py): the C
FastConverter converts a window of frames into one packed arena, the
arena reaches the device in one copy, and the same step runs on it
(convert_raw_batch / train_converted_batch, driven by
framework/dispatch.IngestPipeline).  The default "sequential" mode
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
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jubatus_tpu_torch.batching.arenas import ArenaPool, arena_to_device
from jubatus_tpu_torch.batching.bucketing import (B_BUCKETS as _B_BUCKETS,
                                                  fuse_sparse_batches,
                                                  round_b as _round_b,
                                                  split_groups)
from jubatus_tpu_torch.device import device_context, resolve_device
from jubatus_tpu_torch.fv import ConverterConfig, Datum, DatumToFVConverter
from jubatus_tpu_torch.fv.converter import _K_BUCKETS
from jubatus_tpu_torch.fv.fast import make_fast_converter
from jubatus_tpu_torch.fv.weight_manager import WeightManager
from jubatus_tpu_torch.kernels import build
from jubatus_tpu_torch.models.base import Driver, RawBatch, register_driver
from jubatus_tpu_torch.ops.sparse import batch_scores, ftz, sample_scores

MARGIN_METHODS = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")
CENTROID_METHODS = ("cosine", "euclidean")
# method ids of csrc/train_scan.cu (enum Method)
_METHOD_ID = {m: i for i, m in enumerate(MARGIN_METHODS)}

# the JAX package's historical import path of the fused-batch builder
coalesce_sparse_batches = fuse_sparse_batches


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

    Subnormals are flushed as XLA flushes them (ops.sparse.ftz): the
    gathered w and cov, the values, mask and c read as zero where
    subnormal, and every elementwise result flushes, the scatter-add's
    too (the touched columns of w are flushed before and after it).  The
    inner partial sums of the reductions (scores, |x|^2, v) and of a
    column's duplicate entries in the scatter-add are not flushed one by
    one.

    w, cov: [L, D] f32   counts: [L] i32   active: [L] bool
    indices/values: [B, K]   labels: [B] i32   mask: [B] f32 (0 = padding)
    """
    dev = w.device
    cf = ftz(torch.tensor(c, dtype=torch.float32, device=dev))
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    half_c = ftz(0.5 / cf)
    for b in range(indices.shape[0]):
        if not bool(ftz(mask[b]) > 0):
            continue                       # padding datum: a no-op step
        idx = indices[b].long()
        val = ftz(values[b])
        y = int(labels[b])
        s = sample_scores(w, idx, val)                      # [L]
        active[y] = True
        counts[y] += 1
        rival = torch.where(active, s, neg_inf)
        rival[y] = neg_inf
        r = int(torch.argmax(rival))       # first maximum; 0 if all -inf
        margin = ftz(s[y] - rival[r])
        x2 = ftz(val * val)
        sqn = ftz(x2.sum())
        if not (bool(torch.isfinite(rival[r])) and bool(sqn > 0)):
            continue                       # not ok: every table unchanged
        if method == "perceptron":
            alpha = torch.where(margin <= 0, 1.0, 0.0)
            dy, dr = ftz(alpha * val), ftz(-alpha * val)
        elif method in ("PA", "PA1", "PA2"):
            loss = ftz(1.0 - margin)
            if method == "PA":
                tau = ftz(loss / ftz(2.0 * sqn))
            elif method == "PA1":
                tau = torch.minimum(cf, ftz(loss / ftz(2.0 * sqn)))
            else:
                tau = ftz(loss / ftz(ftz(2.0 * sqn) + half_c))
            tau = torch.where(loss > 0, tau, zero)
            dy, dr = ftz(tau * val), ftz(-tau * val)
        else:
            cy = ftz(cov[y, idx])
            cr = ftz(cov[r, idx])
            v = ftz(ftz(x2 * ftz(cy + cr)).sum())
            if method == "AROW":
                beta = ftz(1.0 / ftz(v + cf))
                gate = margin < 1.0
                alpha = torch.where(gate, ftz(torch.clamp_min(
                    ftz(1.0 - margin), 0.0) * beta), zero)
                g = torch.where(gate, beta, zero)
                dy = ftz(ftz(alpha * cy) * val)
                dr = ftz(ftz(-alpha * cr) * val)
                ncy = ftz(cy - ftz(ftz(ftz(g * cy) * cy) * x2))
                ncr = ftz(cr - ftz(ftz(ftz(g * cr) * cr) * x2))
            elif method == "CW":
                phi = cf
                t = ftz(1.0 + ftz(ftz(2.0 * phi) * margin))
                inner = ftz(ftz(t * t) - ftz(ftz(8.0 * phi) * ftz(
                    margin - ftz(phi * v))))
                gamma = ftz(ftz(-t + ftz(torch.sqrt(torch.clamp_min(
                    inner, 0.0)))) / ftz(ftz(4.0 * phi)
                                         * torch.clamp_min(v, 1e-12)))
                alpha = torch.clamp_min(gamma, 0.0)
                dy = ftz(ftz(alpha * cy) * val)
                dr = ftz(ftz(-alpha * cr) * val)
                g = ftz(ftz(2.0 * alpha) * phi)
                ncy = ftz(1.0 / ftz(ftz(1.0 / torch.clamp_min(cy, 1e-12))
                                    + ftz(g * x2)))
                ncr = ftz(1.0 / ftz(ftz(1.0 / torch.clamp_min(cr, 1e-12))
                                    + ftz(g * x2)))
            else:  # NHERD
                gate = margin < 1.0
                alpha = torch.where(gate, ftz(torch.clamp_min(
                    ftz(1.0 - margin), 0.0) / ftz(v + cf)), zero)
                g = torch.where(gate, ftz(ftz(2.0 * cf) + ftz(
                    ftz(cf * cf) * v)), zero)
                dy = ftz(ftz(alpha * cy) * val)
                dr = ftz(ftz(-alpha * cr) * val)
                denom = ftz(1.0 + ftz(g * x2))
                ncy = ftz(cy / denom)
                ncr = ftz(cr / denom)
            keep = _last_occurrence(idx)
            cov[y, idx[keep]] = ncy[keep]
            cov[r, idx[keep]] = ncr[keep]
        for row, d in ((y, dy), (r, dr)):
            w[row, idx] = ftz(w[row, idx])
            w[row].index_add_(0, idx, d)
            w[row, idx] = ftz(w[row, idx])


# Launch plan of csrc/train_scan.cu (enum Mode, struct Plan there): where
# the kernel reads the tables of each datum from, and the depth W of its
# prefetch ring.  RING_ALL prefetches w (and cov) of all L rows per slot;
# RING_W prefetches w and reads cov of rows y and r on demand; DIRECT
# prefetches only the batch entries.
SCAN_RING_ALL, SCAN_RING_W, SCAN_DIRECT = 0, 1, 2
SCAN_RING = 3             # ring depth: the fastest measured (PERF.md)
SCAN_PRODUCERS = 2        # producer warps: the fastest measured
SCAN_MAX_RING = 8         # deepest ring the kernel takes (MAX_RING)
SCAN_SMEM_LIMIT = 232448  # shared memory one block can opt into on sm_90


def scan_smem_bytes(mode: int, has_cov: bool, ring: int, n_labels: int,
                    k: int) -> int:
    """Shared-memory bytes of the scan kernel's layout (make_plan in
    csrc/train_scan.cu): barriers, counts/active, per-datum scratch, W
    ring slots (with a column hash of at least 8K entries where tables
    are prefetched) and W log entries."""
    ntab = (2 if has_cov else 1) if mode == SCAN_RING_ALL else \
        (1 if mode == SCAN_RING_W else 0)
    log_cov = mode == SCAN_RING_ALL and has_cov
    hash_size = max(32, 1 << (8 * k - 1).bit_length()) if ntab else 0
    slot = 16 + 16 * k + 4 * hash_size + 4 * ntab * n_labels * (k + 1)
    log = 16 + 4 * k * (5 if log_cov else 3) if ntab else 0
    return 24 * ring + 8 * n_labels + 16 * k + ring * (slot + log)


def scan_plan(n_labels: int, k: int, has_cov: bool, ring: int = SCAN_RING,
              limit: int = SCAN_SMEM_LIMIT) -> Tuple[int, int]:
    """(mode, W) for a launch at L labels and K entries per datum: the
    first mode, in the order RING_ALL, RING_W, DIRECT, whose ring holds at
    least one slot within `limit` bytes, at the deepest W <= ring (and <=
    SCAN_MAX_RING) that fits.  Raises ValueError where not even one DIRECT
    slot fits."""
    modes = (SCAN_RING_ALL, SCAN_RING_W, SCAN_DIRECT) if has_cov \
        else (SCAN_RING_ALL, SCAN_DIRECT)
    for mode in modes:
        depth = min(ring, SCAN_MAX_RING)
        while depth >= 1 and scan_smem_bytes(mode, has_cov, depth, n_labels,
                                             k) > limit:
            depth -= 1
        if depth >= 1:
            return mode, depth
    raise ValueError(
        f"train_scan: L={n_labels} labels and K={k} entries per datum need "
        f"{scan_smem_bytes(SCAN_DIRECT, has_cov, 1, n_labels, k)} bytes of "
        f"shared memory even without table prefetch; one block has "
        f"{limit}")


def _scan_lib() -> ctypes.CDLL:
    lib = build.load("train_scan")
    lib.train_scan_grid_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.train_scan_grid_launch.restype = ctypes.c_int
    lib.train_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.train_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch_grid(name, w, cov, counts, active, indices, values, labels,
                 mask, method: str, c: float):
    """Checks stacked state (w [ndp, L, D], cov [ndp, L, D] in the CW
    family, counts/active [ndp, L]) and a batch of ndp * B datums on one
    CUDA device, then makes ONE launch of csrc/train_scan.cu's grid, ndp
    blocks, replica r on rows [r * B, (r + 1) * B); planned by scan_plan
    at ring depth SCAN_RING with SCAN_PRODUCERS producer warps (at most
    the depth).  -> ((mode, depth, producers), the launch's CUDA error
    code).  Raises before launching on a bad tensor."""
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dim() != 3:
        raise ValueError(f"{name}: want w [ndp, L, D], got "
                         f"{tuple(w.shape)}")
    ndp, l, d = w.shape
    b, k = indices.shape
    if b % ndp:
        raise ValueError(f"{name}: B={b} datums do not split into {ndp} "
                         f"replicas")
    want = [(w, torch.float32), (counts, torch.int32), (active, torch.bool),
            (indices, torch.int32), (values, torch.float32),
            (labels, torch.int32), (mask, torch.float32)]
    if _has_cov(method):
        want.append((cov, torch.float32))
        if tuple(cov.shape) != (ndp, l, d):
            raise ValueError(f"cov shape {tuple(cov.shape)} != w "
                             f"{(ndp, l, d)}")
    for t, dt in want:
        if t.dtype != dt or t.device != w.device or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt} on {w.device}, "
                             f"got {t.dtype} on {t.device}")
    if tuple(values.shape) != (b, k) or tuple(labels.shape) != (b,) \
            or tuple(mask.shape) != (b,) or tuple(counts.shape) != (ndp, l) \
            or tuple(active.shape) != (ndp, l):
        raise ValueError(f"{name}: inconsistent batch/state shapes")
    mode, depth = scan_plan(l, k, _has_cov(method), SCAN_RING)
    nprod = min(depth, SCAN_PRODUCERS)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _scan_lib().train_scan_grid_launch(
        w.data_ptr(), cov.data_ptr(), counts.data_ptr(), active.data_ptr(),
        indices.data_ptr(), values.data_ptr(), labels.data_ptr(),
        mask.data_ptr(), b // ndp, k, l, d, _METHOD_ID[method], float(c),
        mode, depth, nprod, ndp, stream)
    return (mode, depth, nprod), err


def train_scan(w, cov, counts, active, indices, values, labels, mask,
               method: str, c: float) -> None:
    """Sequential online updates over one microbatch, in place.  CUDA
    tensors: one launch of csrc/train_scan.cu, the replica grid at one
    block (_launch_grid).  CPU tensors: the plain version.  Shapes as
    train_scan_ref; indices/labels int32."""
    if w.device.type == "cpu":
        train_scan_ref(w, cov, counts, active, indices, values, labels,
                       mask, method, c)
        return
    plan, err = _launch_grid(
        "train_scan", w.unsqueeze(0), cov.unsqueeze(0), counts.unsqueeze(0),
        active.unsqueeze(0), indices, values, labels, mask, method, c)
    train_scan.launches += 1
    train_scan.last_plan = plan
    build.check(err, "train_scan launch")


train_scan.launches = 0
train_scan.last_plan = None


# ---------------------------------------------------------------------------
# the replica grid: ndp replicas' scans in one launch (parallel/dp.py)
# ---------------------------------------------------------------------------

def train_scan_grid_ref(w, cov, counts, active, indices, values, labels,
                        mask, method: str, c: float) -> None:
    """Plain version of the replica grid: train_scan_ref of replica r on
    rows [r * B/ndp, (r + 1) * B/ndp) of the batch, for each r in turn.
    w, cov: [ndp, L, D] (cov [ndp, 1, 1] outside the CW family),
    counts, active: [ndp, L]; the batch as train_scan_ref's, B a multiple
    of ndp."""
    ndp = w.shape[0]
    per = indices.shape[0] // ndp
    for r in range(ndp):
        rows = slice(r * per, (r + 1) * per)
        train_scan_ref(w[r], cov[r], counts[r], active[r], indices[rows],
                       values[rows], labels[rows], mask[rows], method, c)


def train_scan_grid(w, cov, counts, active, indices, values, labels, mask,
                    method: str, c: float) -> None:
    """ndp replicas' sequential updates in place, replica r on its slice
    of the batch (the JAX package's shard_map of train_scan_impl over dp).
    CUDA tensors: ONE launch of csrc/train_scan.cu's replica grid, ndp
    blocks planned as one scan_plan launch (the plan depends on L and K,
    not on the datums a block), counted apart from train_scan's.  CPU
    tensors: the plain version.  Shapes as train_scan_grid_ref."""
    if w.device.type == "cpu":
        train_scan_grid_ref(w, cov, counts, active, indices, values, labels,
                            mask, method, c)
        return
    plan, err = _launch_grid("train_scan_grid", w, cov, counts, active,
                             indices, values, labels, mask, method, c)
    train_scan_grid.launches += 1
    train_scan_grid.last_plan = plan + (w.shape[0],)
    build.check(err, "train_scan_grid launch")


train_scan_grid.launches = 0
train_scan_grid.last_plan = None


# ---------------------------------------------------------------------------
# parallel (mini-batch) mode, centroid methods and scoring: torch ops
# ---------------------------------------------------------------------------

def train_parallel(w, cov, counts, active, indices, values, labels, mask,
                   method: str, c: float) -> None:
    """Mini-batch online updates, in place (train_parallel_impl of the
    JAX package): every sample's margin is computed against the weights as
    of the START of the batch, then all updates land in one scatter-add
    (w) and one scatter-multiply (cov, factors clamped at >= 1e-6; a
    column hit twice in the batch compounds its factors).  Subnormals are
    flushed as in train_scan_ref: the inputs, every elementwise result
    and the touched table entries before and after each scatter; the
    inner partial sums of the reductions and of a column's duplicate
    entries are not."""
    dev = w.device
    cf = ftz(torch.tensor(c, dtype=torch.float32, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    idx = indices.long()
    lab = labels.long()
    values = ftz(values)
    live = ftz(mask) > 0                                     # [B]
    s = batch_scores(w, idx, values)                         # [B, L]
    brange = torch.arange(idx.shape[0], device=dev)

    counts.index_add_(0, lab, live.to(torch.int32))
    active |= counts > 0

    sy = s[brange, lab]
    rival = torch.where(active[None, :], s, float("-inf"))
    rival[brange, lab] = float("-inf")
    r = torch.argmax(rival, dim=1)                           # [B]
    rmax = rival[brange, r]
    margin = ftz(sy - rmax)
    x2 = ftz(values * values)                                # [B, K]
    sqn = ftz(x2.sum(dim=1))
    ok = live & torch.isfinite(rmax) & (sqn > 0)

    fac_y = fac_r = None
    if method == "perceptron":
        alpha = torch.where(ok & (margin <= 0), 1.0, 0.0)
        dy = ftz(alpha[:, None] * values)
        dr = -dy
    elif method in ("PA", "PA1", "PA2"):
        loss = ftz(1.0 - margin)
        if method == "PA":
            tau = ftz(loss / ftz(2.0 * torch.clamp_min(sqn, 1e-12)))
        elif method == "PA1":
            tau = torch.minimum(cf, ftz(loss / ftz(
                2.0 * torch.clamp_min(sqn, 1e-12))))
        else:
            tau = ftz(loss / ftz(ftz(2.0 * sqn) + ftz(0.5 / cf)))
        tau = torch.where(ok & (loss > 0), tau, zero)
        dy = ftz(tau[:, None] * values)
        dr = -dy
    else:
        cy = ftz(cov[lab[:, None], idx])                     # [B, K]
        cr = ftz(cov[r[:, None], idx])
        v = ftz(ftz(x2 * ftz(cy + cr)).sum(dim=1))           # [B]
        if method == "AROW":
            beta = ftz(1.0 / ftz(v + cf))
            gate = ok & (margin < 1.0)
            alpha = torch.where(gate, ftz(torch.clamp_min(
                ftz(1.0 - margin), 0.0) * beta), zero)
            dy = ftz(ftz(alpha[:, None] * cy) * values)
            dr = ftz(ftz(-alpha[:, None] * cr) * values)
            g = torch.where(gate, beta, zero)[:, None]
            fac_y = ftz(1.0 - ftz(ftz(g * cy) * x2))
            fac_r = ftz(1.0 - ftz(ftz(g * cr) * x2))
        elif method == "CW":
            phi = cf
            t = ftz(1.0 + ftz(ftz(2.0 * phi) * margin))
            inner = ftz(ftz(t * t) - ftz(ftz(8.0 * phi) * ftz(
                margin - ftz(phi * v))))
            gamma = ftz(ftz(-t + ftz(torch.sqrt(torch.clamp_min(
                inner, 0.0)))) / ftz(ftz(4.0 * phi)
                                     * torch.clamp_min(v, 1e-12)))
            alpha = torch.where(ok, torch.clamp_min(gamma, 0.0), zero)
            dy = ftz(ftz(alpha[:, None] * cy) * values)
            dr = ftz(ftz(-alpha[:, None] * cr) * values)
            a2 = ftz(ftz(ftz(2.0 * alpha[:, None]) * phi) * x2)
            fac_y = ftz(1.0 / ftz(1.0 + ftz(a2 * cy)))
            fac_r = ftz(1.0 / ftz(1.0 + ftz(a2 * cr)))
        else:  # NHERD
            gate = ok & (margin < 1.0)
            alpha = torch.where(gate, ftz(torch.clamp_min(
                ftz(1.0 - margin), 0.0) / ftz(v + cf)), zero)
            dy = ftz(ftz(alpha[:, None] * cy) * values)
            dr = ftz(ftz(-alpha[:, None] * cr) * values)
            denom = ftz(1.0 + ftz(ftz(
                torch.where(gate, 1.0, 0.0)[:, None]
                * ftz(ftz(2.0 * cf) + ftz(ftz(cf * cf) * v[:, None])))
                * x2))
            fac_y = ftz(1.0 / denom)
            fac_r = fac_y

    rows = torch.cat([lab, r])[:, None].expand(-1, idx.shape[1])  # [2B, K]
    idx2 = torch.cat([idx, idx], dim=0)
    upd = torch.cat([dy, dr], dim=0)
    w[rows, idx2] = ftz(w[rows, idx2])
    w.index_put_((rows, idx2), upd, accumulate=True)
    w[rows, idx2] = ftz(w[rows, idx2])
    if fac_y is not None:
        fac = torch.clamp_min(torch.cat([fac_y, fac_r], dim=0), 1e-6)
        cov[rows, idx2] = ftz(cov[rows, idx2])
        flat = (rows * cov.shape[1] + idx2).reshape(-1)
        cov.view(-1).scatter_reduce_(0, flat, fac.reshape(-1), "prod")
        cov[rows, idx2] = ftz(cov[rows, idx2])


def _centroid_train(sums, counts, active, indices, values, labels,
                    mask) -> None:
    """cosine/euclidean keep per-label sums; one batch scatter, in place,
    subnormals flushed as in train_parallel."""
    idx = indices.long()
    rows = labels.long()[:, None].expand_as(idx)
    mask = ftz(mask)
    sums[rows, idx] = ftz(sums[rows, idx])
    sums.index_put_((rows, idx), ftz(ftz(values) * mask[:, None]),
                    accumulate=True)
    sums[rows, idx] = ftz(sums[rows, idx])
    counts.index_add_(0, labels.long(), mask.to(torch.int32))
    active |= counts > 0


def _classify_scores(w, active, indices, values) -> torch.Tensor:
    s = batch_scores(w, indices.long(), values)              # [B, L]
    return torch.where(active[None, :], s, float("-inf"))


def _centroid_scores(sums, counts, active, indices, values,
                     kind: str) -> torch.Tensor:
    """Subnormals flushed: the inputs and every elementwise result and
    reduction."""
    cnt = torch.clamp_min(counts, 1).to(torch.float32)[:, None]
    cents = ftz(ftz(sums) / cnt)                             # [L, D] means
    values = ftz(values)
    dots = batch_scores(cents, indices.long(), values)       # [B, L]
    x2 = ftz(ftz(values * values).sum(dim=-1, keepdim=True))
    c2 = ftz(ftz(cents * cents).sum(dim=-1))[None, :]
    if kind == "cosine":
        xn = ftz(torch.sqrt(x2))
        cn = ftz(torch.sqrt(c2))
        s = ftz(dots / torch.clamp_min(ftz(xn * cn), 1e-12))
    else:  # euclidean: -||x - c||  (monotone in similarity)
        s = -ftz(torch.sqrt(torch.clamp_min(
            ftz(ftz(x2 + c2) - ftz(2.0 * dots)), 0.0)))
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


def _unpack_batch(buf: torch.Tensor, b: int, k: int,
                  per_row_dtype=torch.int32):
    """Zero-copy views of a device-resident _pack_batch blob; the per-row
    lane is viewed as `per_row_dtype` (int32 label rows, or float32
    regression targets)."""
    nb = b * k * 4
    idx = buf[:nb].view(torch.int32).view(b, k)
    val = buf[nb:2 * nb].view(torch.float32).view(b, k)
    per_row = buf[2 * nb:2 * nb + 4 * b].view(per_row_dtype)
    msk = buf[2 * nb + 4 * b:].view(torch.float32)
    return idx, val, per_row, msk


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class ClassifierDriver(Driver):
    service_name = "classifier"

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
        # native wire converter (None when the config needs the Python
        # converter; fv/fast.py decides)
        self._fast = make_fast_converter(self.converter.config, _K_BUCKETS,
                                         _B_BUCKETS)
        # recycled host arenas of the batched convert, pinned for cuda
        self.arena_pool = ArenaPool(pinned=self.device.type == "cuda")
        self.labels: Dict[str, int] = {}          # label -> row
        self._free_rows: List[int] = []           # rows orphaned by delete_label
        # two-stage raw train (framework/dispatch.py): convert_lock
        # serializes stage 1 (native parse + label interning, WITHOUT the
        # model lock, so it overlaps device steps); _label_mutex makes
        # label interning atomic against the decoded train path;
        # _fast_gen detects an admin op (clear/delete_label/load) that
        # replaced the native label table between the stages
        self.convert_lock = threading.Lock()
        self._label_mutex = threading.Lock()
        self._fast_gen = 0
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

    def _label_row(self, label: str, grow: bool = True) -> int:
        """Intern a label -> model row.  grow=False (stage-1 conversion,
        model lock NOT held) defers the device-table resize to stage 2,
        which runs under the model write lock."""
        with self._label_mutex:
            row = self.labels.get(label)
            if row is None:
                if self._free_rows:
                    row = self._free_rows.pop()  # deleted rows already zeroed
                else:
                    row = max(self.labels.values(), default=-1) + 1
                    if grow and row >= self.capacity:
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
        # the same stage 2 as the raw path
        self._dispatch_converted(batch.indices, batch.values, labels, mask,
                                 len(data))
        return len(data)

    def _convert_raw(self, msg: bytes, params_off: int, grow: bool = True):
        """Raw request bytes -> (n, indices, values, labels, mask,
        rows_needed) through the native converter, new labels interned on
        both sides.  grow=False defers device-table growth to stage 2."""
        n, b, k, labels_ba, idx_b, val_b, unknowns = self._fast.convert(
            msg, params_off, 0)
        if n == 0:
            return 0, None, None, None, None, 0
        labels = np.frombuffer(labels_ba, np.int32)
        need = 0
        for pos, lb in unknowns:
            row = self._label_row(lb.decode(), grow=grow)
            self._fast.set_label_row(lb, row)
            labels[pos] = row
            need = max(need, row + 1)
        indices = np.frombuffer(idx_b, np.int32).reshape(b, k)
        values = np.frombuffer(val_b, np.float32).reshape(b, k)
        mask = np.zeros((b,), np.float32)
        mask[:n] = 1.0
        return n, indices, values, labels, mask, need

    def _mark_touched(self, indices) -> None:
        """Record the hashed feature columns a batch touches (col-sparse
        diffs).  Padding zeros mark column 0 — one extra diff column."""
        self._touched_cols[np.asarray(indices).reshape(-1)] = True

    def _dispatch_converted(self, indices, values, labels, mask, n: int,
                            packed=None) -> None:
        """Stage 2 (caller holds the model write lock): one host->device
        copy of the packed blob, then the train kernel over its views.
        `packed` (the native batched-convert arena, already in
        _pack_batch layout) skips the host re-pack.  An arena of the
        pinned pool is copied asynchronously from its pinned tensor; on
        the CPU the arena is viewed zero-copy."""
        self._mark_touched(indices)
        b, k = np.asarray(indices).shape
        nbytes = 2 * b * k * 4 + 8 * b
        if packed is None:
            packed = _pack_batch(indices, values, labels, mask)
        with device_context(self.device):
            buf = arena_to_device(packed, nbytes, self.device)
            idx, val, lbl, msk = _unpack_batch(buf, b, k)
            if self._is_centroid:
                _centroid_train(self.w, self.counts, self.active, idx, val,
                                lbl, msk)
            else:
                step = train_parallel if self.batch_mode == "parallel" \
                    else train_scan
                step(self.w, self.cov, self.counts, self.active, idx, val,
                     lbl, msk, self.method, self.c)
        self._updates_since_mix += n

    def train_raw(self, msg: bytes, params_off: int) -> int:
        """Wire fast path: raw msgpack request bytes -> one device step.
        The C converter parses the params subtree [name, [[label, datum],
        ...]] into padded [B, K] buffers with no per-datum Python.  Caller
        holds the model write lock."""
        n, indices, values, labels, mask, _ = self._convert_raw(msg,
                                                                params_off)
        if n == 0:
            return 0
        self._dispatch_converted(indices, values, labels, mask, n)
        return n

    def convert_raw_request(self, msg: bytes, params_off: int):
        """Stage 1 of the per-request raw train (caller holds convert_lock
        but NOT the model lock): native parse + label interning.  Table
        growth and the device step wait for train_converted."""
        gen = self._fast_gen
        n, indices, values, labels, mask, need = self._convert_raw(
            msg, params_off, grow=False)
        return (gen, msg, params_off, n, indices, values, labels, mask, need)

    def train_converted(self, conv) -> int:
        """Stage 2 (caller holds the model write lock): grow if stage 1
        interned rows past capacity, then dispatch.  A conversion made
        against a native label table that an admin op (clear,
        delete_label, load) has since replaced is redone here."""
        gen, msg, params_off, n, indices, values, labels, mask, need = conv
        if gen != self._fast_gen:
            return self.train_raw(msg, params_off)
        if n == 0:
            return 0
        if need > self.capacity:
            self._grow(need)
        self._dispatch_converted(indices, values, labels, mask, n)
        return n

    def train_converted_many(self, convs) -> List[int]:
        """Several stage-1 conversions as ONE device step (caller holds
        the model write lock).  Exact for the "sequential" mode: scanning
        r1||r2 is scanning r1 then r2; the "parallel" mode gets a wider
        minibatch."""
        fresh = [c for c in convs if c[0] == self._fast_gen and c[3] > 0]
        out_map = {}
        for c in convs:
            if c[0] != self._fast_gen:                # stale: redo inline
                out_map[id(c)] = self.train_raw(c[1], c[2])
            elif c[3] == 0:
                out_map[id(c)] = 0
        if fresh:
            need = max(c[8] for c in fresh)
            if need > self.capacity:
                self._grow(need)
            if len(fresh) == 1:
                _, _, _, n, indices, values, labels, mask, _ = fresh[0]
                self._dispatch_converted(indices, values, labels, mask, n)
            else:
                indices, values, labels, mask = coalesce_sparse_batches(
                    [(c[4], c[5], c[6], c[7]) for c in fresh])
                self._dispatch_converted(indices, values, labels, mask,
                                         sum(c[3] for c in fresh))
            for c in fresh:
                out_map[id(c)] = c[3]
        return [out_map[id(c)] for c in convs]

    def convert_raw_batch(self, frames) -> RawBatch:
        """Stage 1, fused: N raw train frames -> ONE packed arena from the
        driver's arena pool, in a single native call that releases the GIL.
        Caller holds convert_lock but NOT the model lock.  The layout and
        bucketing equal converting each frame with convert_raw_request and
        fusing with fuse_sparse_batches + _pack_batch, byte for byte."""
        gen = self._fast_gen
        frames = list(frames)
        ns, b, k, arena, unknowns = self._fast.convert_raw_batch(
            frames, 0, self.arena_pool.acquire)
        need = 0
        if unknowns:
            # label rows live in the arena's aux slot: patch them in
            # place after interning, in the order the per-request path
            # interns them, so rows are assigned identically
            lab = np.frombuffer(arena, np.int32, count=b,
                                offset=2 * b * k * 4)
            for row, lb in unknowns:
                r = self._label_row(lb.decode(), grow=False)
                self._fast.set_label_row(lb, r)
                lab[row] = r
                need = max(need, r + 1)
        return RawBatch(gen, frames, list(ns), b, k, arena, need)

    def train_converted_batch(self, rb: RawBatch) -> List[int]:
        """Stage 2, fused (caller holds the model write lock): grow if
        stage 1 interned rows past capacity, then ONE device step for the
        whole window.  A stale generation redoes every frame."""
        if rb.gen != self._fast_gen:
            return [self.train_raw(bytes(m), int(o)) for m, o in rb.frames]
        if rb.b == 0:
            return list(rb.ns)
        if rb.need > self.capacity:
            self._grow(rb.need)
        b, k = rb.b, rb.k
        indices = np.frombuffer(rb.arena, np.int32, count=b * k).reshape(b, k)
        self._dispatch_converted(indices, None, None, None, rb.total,
                                 packed=rb.arena)
        return list(rb.ns)

    def _fast_rebuild(self) -> None:
        """Recreate the native label table after clear/delete/unpack so no
        stale label->row mapping survives.  Bumps _fast_gen so a stage-1
        conversion against the old table is redone in stage 2."""
        self._fast_gen += 1
        if self._fast is None:
            return
        self._fast = make_fast_converter(self.converter.config, _K_BUCKETS,
                                         _B_BUCKETS)
        for lbl, row in list(self.labels.items()):
            self._fast.set_label_row(lbl.encode(), row)

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
        with self._label_mutex:
            row = self.labels.pop(label, None)
        if row is None:
            return False
        if row >= self.capacity:
            # interned by a stage-1 conversion not yet dispatched: no
            # device state exists for it; the pending conversion is redone
            # against the rebuilt table
            self._fast_rebuild()
            return True
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
        with self._label_mutex:
            self._free_rows.append(row)
        self._fast_rebuild()
        return True

    def clear(self) -> None:
        self._touched_cols[:] = False
        self._unconfirmed_cols = None
        with self._label_mutex:
            self.labels.clear()
            self._free_rows = []
        self.capacity = self.INITIAL_CAPACITY
        self._alloc()
        self.converter.weights.clear()
        self._updates_since_mix = 0
        self._w_base = None
        self._cov_base = None
        self._counts_base = None
        self._fast_rebuild()

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
        return self._subtract_bases(self.get_diff_snapshot())

    def _mix_tables(self):
        """(w, cov, counts) the diff is read from: the model's tables (a
        data-parallel driver's replica 0, parallel/dp.py)."""
        return self.w, self.cov, self.counts

    def get_diff_snapshot(self) -> Dict[str, Any]:
        """The part of get_diff taken under the model write lock: the
        harvest, one device gather of the [rows x touched] block to the
        host, and a copy of its bases; encode_diff subtracts them."""
        self._ensure_base()
        J = self._harvest_touched_cols()
        label_rows = {l: r for l, r in list(self.labels.items())
                      if r < self.capacity}
        labels = sorted(label_rows, key=label_rows.get)
        rows = np.array([label_rows[l] for l in labels], np.int64)
        w, cov, counts_t = self._mix_tables()
        counts = counts_t.cpu().numpy()
        diff = {
            "labels": labels,
            "dim": self.dim,
            "cols": J,
            "counts": counts[rows] - self._counts_base[rows],
            "k": 1,
            "weights": self.converter.weights.get_diff(),
        }
        if len(rows) and J.size:
            diff["w"] = self._gather(w, rows, J)
            diff["w_base"] = self._w_base[np.ix_(rows, J)]
            if _has_cov(self.method):
                diff["cov"] = self._gather(cov, rows, J)
                diff["cov_base"] = self._cov_base[np.ix_(rows, J)]
        else:
            diff["w"] = np.zeros((len(rows), J.size), np.float32)
            if _has_cov(self.method):
                diff["cov"] = np.zeros((len(rows), J.size), np.float32)
        return diff

    def encode_diff(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Outside the lock: a snapshot's subtraction, the optional top-k
        column sparsification (--mix_topk), then the optional per-row
        int8 transport quantization ({"dcn_payload": "int8"})."""
        return self._quantize_diff_payload(
            self._sparsify_topk(self._subtract_bases(snap)))

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
        self._fast_rebuild()

    def get_status(self) -> Dict[str, str]:
        return {
            "num_classes": str(len(self.labels)),
            "num_features": str(self.dim),
            "method": self.method,
        }


class NNClassifierDriver(Driver):
    """method "NN": a k-NN vote over a nearest_neighbor row table
    (counterpart of jubatus_tpu/models/classifier.py NNClassifierDriver:
    jubatus_core's nearest_neighbor_classifier, each of the k nearest
    stored rows voting exp(-local_sensitivity * distance) for its label).

    The rows live in the port's NearestNeighborDriver on this driver's
    device: train is its set_row_many (one K1/K2 launch and one write a
    request), classify is one fused_sig_query_batch (K1/K2, then one K3
    launch with kb = _round_k(k), signed as the JAX driver's batch padded
    to round_b).  Labels live in host dicts keyed by the rows' ids, which
    are random and unique across servers (uuid4), so MIX is the table
    union plus a label-map union, and model files cross packages."""

    service_name = "classifier"

    def __init__(self, config: Dict[str, Any], device=None):
        super().__init__(config)
        from jubatus_tpu_torch.models.nearest_neighbor import \
            NearestNeighborDriver
        self.method = "NN"
        param = config.get("parameter") or {}
        self.k = int(param.get("nearest_neighbor_num", 128))
        self.alpha = float(param.get("local_sensitivity", 1.0))
        self.nn = NearestNeighborDriver({
            "method": param.get("method", "euclid_lsh"),
            "parameter": param.get("parameter") or {},
            "converter": config.get("converter"),
        }, device=device)
        self.device = self.nn.device
        self.row_labels: Dict[str, str] = {}
        self.label_counts: Dict[str, int] = {}
        self._pending_labels: Dict[str, str] = {}
        self._diff_labels: Dict[str, str] = {}
        # labels deleted since the last round: put_diff must not bring
        # them back from an in-flight diff or a peer's rows
        self._deleted_labels: set = set()

    # -- RPC surface ----------------------------------------------------------

    def train(self, data: Sequence[Tuple[str, Datum]]) -> int:
        import uuid
        rows = [(uuid.uuid4().hex[:16], datum) for _, datum in data]
        # the rows first: a failed write must leave no label behind
        self.nn.set_row_many(rows)
        for (rid, _), (label, _) in zip(rows, data):
            self.row_labels[rid] = label
            self._pending_labels[rid] = label
            self.label_counts[label] = self.label_counts.get(label, 0) + 1
        return len(data)

    def classify(self, data: Sequence[Datum]) -> List[List[Tuple[str, float]]]:
        if not data:
            return []
        nn = self.nn
        if not nn.row_ids:
            return [sorted((lbl, 0.0) for lbl in self.label_counts)
                    for _ in data]
        from jubatus_tpu_torch.ops import lsh as lshops
        batch = nn.converter.convert_batch(list(data))
        qnorms = np.sqrt((batch.values * batch.values).sum(axis=1))
        with device_context(nn.device):
            rows_b, sims_b = lshops.fused_sig_query_batch(
                nn.method, nn.key, batch.indices, batch.values, nn.sig,
                nn.norms, nn.pages.n_rows, nn.hash_num, qnorms, self.k,
                _round_b(len(data)))
        known_labels = list(self.label_counts)
        row_labels = self.row_labels
        out: List[List[Tuple[str, float]]] = []
        for i in range(len(data)):
            votes: Dict[str, float] = {lbl: 0.0 for lbl in known_labels}
            voted = 0
            for r, s in zip(rows_b[i], sims_b[i]):
                # exactly k voters (the sweep returns kb >= k rows)
                if not np.isfinite(s) or voted >= self.k:
                    break
                voted += 1
                dist = float(-s) if nn.method == "euclid_lsh" \
                    else float(1.0 - s)
                label = row_labels.get(nn.row_ids[int(r)])
                if label is not None:
                    votes[label] = votes.get(label, 0.0) + \
                        float(np.exp(-self.alpha * max(dist, 0.0)))
            out.append(sorted(votes.items()))
        return out

    def classify_many(self, groups: Sequence[Sequence[Datum]]
                      ) -> List[List[List[Tuple[str, float]]]]:
        """The read lane's entry: one classify of every request's datums,
        demuxed per request."""
        flat = [d for g in groups for d in g]
        return split_groups(self.classify(flat), groups)

    def get_labels(self) -> Dict[str, int]:
        return dict(self.label_counts)

    def set_label(self, label: str) -> bool:
        if label in self.label_counts:
            return False
        self.label_counts[label] = 0
        return True

    def delete_label(self, label: str) -> bool:
        if label not in self.label_counts:
            return False
        del self.label_counts[label]
        # the label's rows stay in the table, unlabeled: they never vote
        # again; pending entries go too, or MIX would bring the label back
        self.row_labels = {r: lb for r, lb in self.row_labels.items()
                           if lb != label}
        self._pending_labels = {r: lb for r, lb in
                                self._pending_labels.items() if lb != label}
        self._deleted_labels.add(label)
        return True

    def clear(self) -> None:
        self.nn.clear()
        self.row_labels.clear()
        self.label_counts.clear()
        self._pending_labels.clear()
        self._deleted_labels.clear()

    # -- MIX ------------------------------------------------------------------

    def get_diff(self) -> Dict[str, Any]:
        labels = dict(self._pending_labels)
        self._diff_labels = labels
        return {"nn": self.nn.get_diff(), "labels": labels}

    @classmethod
    def mix(cls, lhs, rhs):
        from jubatus_tpu_torch.models.nearest_neighbor import \
            NearestNeighborDriver
        labels = dict(lhs["labels"])
        labels.update(rhs["labels"])
        return {"nn": NearestNeighborDriver.mix(lhs["nn"], rhs["nn"]),
                "labels": labels}

    def put_diff(self, diff) -> bool:
        fresh = self.nn.put_diff(diff["nn"])
        dec = lambda x: x.decode() if isinstance(x, bytes) else x  # noqa
        for rid, label in diff["labels"].items():
            label = dec(label)
            if label in self._deleted_labels:
                continue        # deleted mid-round: not brought back
            self.row_labels[dec(rid)] = label
        counts: Dict[str, int] = {lbl: 0 for lbl in self.label_counts
                                  if lbl not in self._deleted_labels}
        for label in self.row_labels.values():
            counts[label] = counts.get(label, 0) + 1
        self.label_counts = counts
        for rid in self._diff_labels:
            self._pending_labels.pop(rid, None)
        self._diff_labels = {}
        self._deleted_labels.clear()
        return fresh

    # -- persistence ----------------------------------------------------------

    def pack(self) -> Dict[str, Any]:
        return {"nn": self.nn.pack(),
                "labels": dict(self.row_labels),
                "label_counts": dict(self.label_counts)}

    def unpack(self, obj) -> None:
        self.nn.unpack(obj["nn"])
        dec = lambda x: x.decode() if isinstance(x, bytes) else x  # noqa
        self.row_labels = {dec(r): dec(lb) for r, lb in obj["labels"].items()}
        self.label_counts = {dec(lb): int(c)
                             for lb, c in obj["label_counts"].items()}
        # a load replaces every label state
        self._pending_labels.clear()
        self._deleted_labels.clear()
        self._diff_labels = {}

    def get_status(self) -> Dict[str, str]:
        st = self.nn.get_status()
        st["nn_method"] = st.get("method", "")
        st.update({"method": "NN",
                   "num_classes": str(len(self.label_counts)),
                   "num_rows": str(len(self.row_labels))})
        return st


def _classifier_factory(config: Dict[str, Any], device=None) -> Driver:
    """The classifier service's drivers: the weight-table driver for the
    margin and centroid methods, the k-NN vote driver for "NN"."""
    if config.get("method") == "NN":
        return NNClassifierDriver(config, device=device)
    return ClassifierDriver(config, device=device)


register_driver("classifier")(_classifier_factory)
