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
tiles, so the wire path is one kernel launch over the zero-padded view,
then a truncation to the array's true size (the padding never crosses the
wire and cannot move a block's absmax).  quantize_blockwise_np /
dequantize_blockwise_np are numpy copies of the JAX package's host codec,
kept for the tests and for chip_smoke.py's timing of the host codec.

The in-mesh int8 ring all-reduce (ring_all_reduce_int8) is later work; it
will reuse these kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jubatus_tpu_torch.kernels import build

BLK_R = 32
BLK_C = 512
_BLOCK = BLK_R * BLK_C


def _lib() -> ctypes.CDLL:
    lib = build.load("quantize")
    for fn in (lib.quantize_int8_launch, lib.dequantize_int8_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
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
    multiplies by the reciprocal, which is not the kernel's IEEE quotient."""
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


# -- kernel wrappers ------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    """[R, C] f32 (R % 32 == 0, C % 512 == 0) -> (int8 [R, C],
    f32 scales [R/32, C/512]), on x's device."""
    _check_tiled(x, torch.float32, "quantize_int8")
    if not _on_cuda(x):
        return _quantize_ref(x)
    r, c = x.shape
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    s = torch.empty((r // BLK_R, c // BLK_C), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().quantize_int8_launch(x.data_ptr(), q.data_ptr(),
                                      s.data_ptr(), r, c, stream)
    quantize_int8.launches += 1
    build.check(err, "quantize_int8 launch")
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
    out = torch.empty((r, c), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().dequantize_int8_launch(q.data_ptr(), s.data_ptr(),
                                        out.data_ptr(), r, c, stream)
    dequantize_int8.launches += 1
    build.check(err, "dequantize_int8 launch")
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
    padded = torch.zeros((nblk * _BLOCK,), dtype=torch.float32,
                         device=x.device)
    padded[:n] = flat
    q, s = quantize_int8(padded.view(nblk * BLK_R, BLK_C))
    return q.reshape(-1)[:n], s.reshape(-1)


def dequantize_blockwise(q: torch.Tensor, s: torch.Tensor,
                         shape) -> torch.Tensor:
    """Inverse of quantize_blockwise; returns f32 of `shape` on q's device."""
    n = q.numel()
    if n == 0:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=q.device)
    nblk = s.numel()
    padded = torch.zeros((nblk * _BLOCK,), dtype=torch.int8, device=q.device)
    padded[:n] = q.reshape(-1)
    out = dequantize_int8(padded.view(nblk * BLK_R, BLK_C),
                          s.reshape(nblk, 1).contiguous())
    return out.reshape(-1)[:n].reshape(tuple(shape))


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
