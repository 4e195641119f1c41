"""Blockwise int8 quantizer: absmax scale per 32x512 tile (counterpart of
jubatus_tpu/parallel/quantized.py).

quantize_int8 / dequantize_int8 are the wrappers of the CUDA kernels in
csrc/quantize.cu, which replace the JAX package's two Pallas kernels.  On
a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor it
runs the plain PyTorch version (_quantize_ref / _dequantize_ref), which
repeats the kernel's arithmetic and is the reference it is tested against.

quantize_blockwise / dequantize_blockwise apply the same math to a
flattened array in contiguous 16384-element blocks — the v3 MIX wire
encoding.  For a row-major [R, 512] view those blocks ARE the 32x512
tiles.  On the card each is one launch over the flat run and one output
allocation: the kernels take the true element count n, read what lies
past it as the zero padding of the JAX codec, and never write it.  On the
CPU they run the plain versions over a zero-padded view, then truncate.
quantize_blockwise_np / dequantize_blockwise_np are numpy copies of the
JAX package's host codec, kept for the tests and for chip_smoke.py's
timing of the host codec.

ring_all_reduce_int8 is the JAX package's in-mesh int8 ring all-reduce
for ranks that live in one process (the data-parallel replicas stacked on
one card): every hop is a device copy along the rank axis, and each
hop's quantize (dequantize) of all ranks is one kernel launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jubatus_tpu_torch.kernels import build

BLK_R = 32
BLK_C = 512
_BLOCK = BLK_R * BLK_C


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The quantizer library, its two entry points bound once."""
    lib = build.load("quantize")
    for fn in (lib.quantize_int8_launch, lib.dequantize_int8_launch):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_tiled(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous 2-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    r, c = t.shape
    if r % BLK_R or c % BLK_C:
        raise ValueError(f"{what}: shape {tuple(t.shape)} is not a whole "
                         f"number of {BLK_R}x{BLK_C} tiles")


def _check_aligned(t: torch.Tensor, what: str) -> None:
    """The kernels move 16 bytes at a time: a view that starts elsewhere
    than on a 16-byte boundary must be copied by the caller."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data at {t.data_ptr():#x} is not 16-byte "
                         f"aligned; pass a fresh tensor (.clone())")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


# -- plain versions -----------------------------------------------------------

def _quantize_ref(x: torch.Tensor):
    """[R, C] f32 -> (int8 [R, C], f32 scales [R/32, C/512]).  Divisions
    are tensor by tensor: PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal, which is not the kernel's IEEE quotient.
    A tile holding a NaN gets a NaN scale (amax and clamp_min keep it)."""
    r, c = x.shape
    blocks = x.reshape(r // BLK_R, BLK_R, c // BLK_C, BLK_C)
    absmax = blocks.abs().amax(dim=(1, 3))
    s = torch.clamp_min(absmax, 1e-30) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(blocks / s[:, None, :, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(r, c), s


def _dequantize_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    r, c = q.shape
    blocks = q.reshape(r // BLK_R, BLK_R, c // BLK_C, BLK_C).to(torch.float32)
    return (blocks * s[:, None, :, None]).reshape(r, c)


# -- kernel launches ------------------------------------------------------------

def _launch_quantize(x, q, s, rows: int, cols: int, n: int) -> None:
    """quant_kernel over the [rows, cols] tile grid of x's first n
    elements, into q (n int8) and s (one scale a tile)."""
    dev = x.device
    with torch.cuda.device(dev):
        err = _lib().quantize_int8_launch(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols, n,
            torch.cuda.current_stream(dev).cuda_stream)
    quantize_int8.launches += 1
    build.check(err, "quantize_int8 launch")


def _launch_dequantize(q, s, out, rows: int, cols: int, n: int) -> None:
    dev = q.device
    with torch.cuda.device(dev):
        err = _lib().dequantize_int8_launch(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), rows, cols, n,
            torch.cuda.current_stream(dev).cuda_stream)
    dequantize_int8.launches += 1
    build.check(err, "dequantize_int8 launch")


# -- kernel wrappers ------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    """[R, C] f32 (R % 32 == 0, C % 512 == 0) -> (int8 [R, C],
    f32 scales [R/32, C/512]), on x's device."""
    _check_tiled(x, torch.float32, "quantize_int8")
    if not _on_cuda(x):
        return _quantize_ref(x)
    _check_aligned(x, "quantize_int8")
    r, c = x.shape
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    s = torch.empty((r // BLK_R, c // BLK_C), dtype=torch.float32,
                    device=x.device)
    _launch_quantize(x, q, s, r, c, r * c)
    return q, s


quantize_int8.launches = 0


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_int8: int8 [R, C] + f32 [R/32, C/512] -> f32."""
    _check_tiled(q, torch.int8, "dequantize_int8")
    r, c = q.shape
    if s.dtype != torch.float32 or tuple(s.shape) != (r // BLK_R, c // BLK_C) \
            or not s.is_contiguous() or s.device != q.device:
        raise ValueError(f"dequantize_int8: scales {s.dtype} "
                         f"{tuple(s.shape)} on {s.device} do not match "
                         f"{tuple(q.shape)} on {q.device}")
    if not _on_cuda(q):
        return _dequantize_ref(q, s)
    _check_aligned(q, "dequantize_int8")
    out = torch.empty((r, c), dtype=torch.float32, device=q.device)
    _launch_dequantize(q, s, out, r, c, r * c)
    return out


dequantize_int8.launches = 0


# -- blockwise (wire) form ----------------------------------------------------

def quantize_blockwise(x: torch.Tensor):
    """f32 tensor (any shape) -> (int8 [x.numel()], f32 scales [nblocks]),
    on x's device; bit-identical to quantize_blockwise_np."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    if n == 0:
        return (torch.zeros((0,), dtype=torch.int8, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device))
    nblk = (n + _BLOCK - 1) // _BLOCK
    if not _on_cuda(flat):
        padded = torch.zeros((nblk * _BLOCK,), dtype=torch.float32)
        padded[:n] = flat
        q, s = quantize_int8(padded.view(nblk * BLK_R, BLK_C))
        return q.reshape(-1)[:n], s.reshape(-1)
    _check_aligned(flat, "quantize_blockwise")
    q = torch.empty((n,), dtype=torch.int8, device=x.device)
    s = torch.empty((nblk,), dtype=torch.float32, device=x.device)
    _launch_quantize(flat, q, s, nblk * BLK_R, BLK_C, n)
    return q, s


def dequantize_blockwise(q: torch.Tensor, s: torch.Tensor,
                         shape) -> torch.Tensor:
    """Inverse of quantize_blockwise; returns f32 of `shape` on q's device."""
    n = q.numel()
    if n == 0:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=q.device)
    nblk = s.numel()
    if nblk * _BLOCK < n:
        raise ValueError(f"dequantize_blockwise: {nblk} scales cover "
                         f"{nblk * _BLOCK} values, not {n}")
    if not _on_cuda(q):
        padded = torch.zeros((nblk * _BLOCK,), dtype=torch.int8)
        padded[:n] = q.reshape(-1)
        out = dequantize_int8(padded.view(nblk * BLK_R, BLK_C),
                              s.reshape(nblk, 1).contiguous())
        return out.reshape(-1)[:n].reshape(tuple(shape))
    flat, sf = q.reshape(-1), s.reshape(-1)
    if flat.dtype != torch.int8 or sf.dtype != torch.float32 \
            or sf.device != q.device:
        raise ValueError(f"dequantize_blockwise: want int8 values and f32 "
                         f"scales on one device, got {q.dtype} on "
                         f"{q.device} and {s.dtype} on {s.device}")
    _check_aligned(flat, "dequantize_blockwise")
    if int(np.prod(tuple(shape), dtype=np.int64)) != n:
        raise ValueError(f"dequantize_blockwise: shape {tuple(shape)} does "
                         f"not hold {n} values")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=q.device)
    _launch_dequantize(flat, sf, out, nblk * BLK_R, BLK_C, n)
    return out


# -- ring all-reduce over ranks held in one process ---------------------------

def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """The exact sum over axis 0 (the ranks) in rank order, x0 + x1 + ...,
    as XLA's CPU all-reduce sums; every rank's copy."""
    total = x[0].clone()
    for r in range(1, x.shape[0]):
        total += x[r]
    return total.unsqueeze(0).expand_as(x).clone()


def ring_all_reduce_int8(x: torch.Tensor, min_elems: int = -1
                         ) -> torch.Tensor:
    """x: [n, ...] f32, one delta a rank -> [n, ...]: every rank's value of
    jubatus_tpu/parallel/quantized.py ring_all_reduce_int8 (≈ the sum over
    ranks, with int8 hops), for n ranks held in one process.

    The same chunked ring: chunk = 32 x 512 x ceil(size / (n * 16384))
    elements a rank, the zero-padded delta cut into n chunks of
    [chunk / 512, 512]; a reduce-scatter of n - 1 hops in which rank r
    receives rank r - 1's quantized running sum and adds its own chunk
    r - t - 1 (cur = dequant(recv) + chunk), so rank r ends holding the
    sum of chunk r + 1; the owner stores dequant(quant(cur)), the value it
    ships; n - 1 all-gather hops forward the once-quantized reduced chunks.
    A hop is a roll by one along the rank axis.  Every chunk is a whole
    number of 32 x 512 tiles, so one quantize_int8 launch over all ranks'
    [n * R, 512] rows quantizes each rank's tiles as its own launch would
    (no tile straddles two ranks); dequantize likewise.  A float leaf's
    round on the card: n quantize and 2n - 1 dequantize launches.

    One arithmetic on both devices, the written one: the kernels on the
    card, their plain versions (_quantize_ref, _dequantize_ref) on the
    CPU, as the JAX ring uses its plain pair off the TPU.  Inside the
    JAX package's fold (parallel/collective.py make_tree_mix) XLA's CPU
    code keeps that arithmetic and the two folds agree bitwise; the ring
    jitted alone it rewrites (the scale's / 127.0 as a multiply by
    float32(1 / 127), a hop's dequantize and add as one fused
    multiply-add), and there the two agree within one quantization step
    of the tile, bitwise where every scale is a whole number.

    Size floor: below min_elems elements a rank (-1: (n * 16384) // 4, the
    break-even point where the padded int8 ring ships more bytes than an
    exact f32 sum), the result is the exact f32 sum in rank order (XLA's
    CPU all-reduce order); 0 always rings.  n == 1 returns x."""
    n = x.shape[0]
    if n == 1:
        return x
    size = x[0].numel()
    if min_elems < 0:
        min_elems = (n * _BLOCK) // 4
    if size < max(min_elems, 1):
        return rank_sum(x)
    flat = x.reshape(n, size).to(torch.float32)
    chunk = _BLOCK * ((size + n * _BLOCK - 1) // (n * _BLOCK))
    rows = chunk // BLK_C
    padded = torch.zeros((n, n * chunk), dtype=torch.float32,
                         device=x.device)
    padded[:, :size] = flat
    # chunks[r, j]: rank r's chunk j, [rows, 512]
    chunks = padded.view(n, n, rows, BLK_C)
    ranks = torch.arange(n, device=x.device)

    def quant(cur):
        q, s = quantize_int8(cur.reshape(n * rows, BLK_C))
        return q.view(n, rows, BLK_C), s.view(n, rows // BLK_R, 1)

    def dequant(q, s):
        return dequantize_int8(q.reshape(n * rows, BLK_C),
                               s.reshape(n * rows // BLK_R, 1)
                               ).view(n, rows, BLK_C)

    # reduce-scatter: after n - 1 hops rank r holds the sum of chunk r + 1
    cur = chunks[ranks, ranks]
    for t in range(n - 1):
        q, s = quant(cur)
        q, s = torch.roll(q, 1, 0), torch.roll(s, 1, 0)   # r gets r - 1's
        cur = dequant(q, s) + chunks[ranks, (ranks - t - 1) % n]
    # all-gather of the once-quantized reduced chunks; the owner keeps the
    # value it ships, dequant(quant(cur)), or replicas would drift apart
    out = torch.empty_like(chunks)
    q, s = quant(cur)
    out[ranks, (ranks + 1) % n] = dequant(q, s)
    for t in range(n - 1):
        q, s = torch.roll(q, 1, 0), torch.roll(s, 1, 0)
        out[ranks, (ranks - t) % n] = dequant(q, s)
    return out.view(n, n * chunk)[:, :size].reshape(x.shape)


# -- numpy copies of the JAX package's host codec (test reference) ---------

def quantize_blockwise_np(x) -> "tuple[np.ndarray, np.ndarray]":
    """f32 array (any shape) -> (int8 [x.size], f32 scales [nblocks])."""
    flat = np.ascontiguousarray(np.asarray(x, np.float32)).reshape(-1)
    n = flat.size
    if n == 0:
        return np.zeros((0,), np.int8), np.zeros((0,), np.float32)
    nblk = (n + _BLOCK - 1) // _BLOCK
    padded = np.zeros((nblk * _BLOCK,), np.float32)
    padded[:n] = flat
    blocks = padded.reshape(nblk, _BLOCK)
    absmax = np.abs(blocks).max(axis=1)
    scales = (np.maximum(absmax, 1e-30) / 127.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, None]), -127.0, 127.0
                ).astype(np.int8)
    return q.reshape(-1)[:n], scales


def dequantize_blockwise_np(q: np.ndarray, scales: np.ndarray,
                            shape) -> np.ndarray:
    """Inverse of quantize_blockwise_np; returns f32 of `shape`."""
    q = np.asarray(q, np.int8).reshape(-1)
    scales = np.asarray(scales, np.float32)
    n = q.size
    if n == 0:
        return np.zeros(shape, np.float32)
    nblk = scales.size
    padded = np.zeros((nblk * _BLOCK,), np.float32)
    padded[:n] = q.astype(np.float32)
    out = (padded.reshape(nblk, _BLOCK) * scales[:, None]).reshape(-1)[:n]
    return out.reshape(shape)
