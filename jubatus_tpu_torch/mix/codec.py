"""msgpack codec for diff objects containing numpy arrays (the port's copy
of jubatus_tpu/mix/codec.py; same tags, same bytes).

Arrays travel as tagged maps {"__nd__": [dtype, shape, bytes]}.
Everything packed for the old-spec wire uses `use_bin_type=False` and
everything unpacked uses `raw=False` + surrogateescape; packb()/unpackb()
pin those options in one place.

The v3 quantized MIX wire ({"__ndq3__": [shape, scales, int8]}) is the
one place a kernel runs: quantize_tree quantizes every float32 tensor of a
diff with the blockwise int8 kernel on `device`, and decode dequantizes
with the inverse kernel on `device`.  `device` is cuda unless the caller
names the CPU, and cuda without a card raises.  The int8 and scale bytes
equal the JAX codec's host computation bit for bit.
"""

from __future__ import annotations

from typing import Any

import msgpack as _msgpack
import numpy as np
import torch

from jubatus_tpu_torch.device import DeviceLike, resolve_device
from jubatus_tpu_torch.parallel.quantized import (_BLOCK,
                                                  dequantize_blockwise,
                                                  quantize_blockwise)
from jubatus_tpu_torch.utils import to_bytes


def packb(obj: Any) -> bytes:
    """Old-wire-spec msgpack pack (raw family only, surrogateescape)."""
    return _msgpack.packb(obj, use_bin_type=False,
                          unicode_errors="surrogateescape")


def unpackb(raw: bytes) -> Any:
    """Old-wire-spec msgpack unpack (str-decoded raw, surrogateescape)."""
    return _msgpack.unpackb(raw, raw=False, strict_map_key=False,
                            unicode_errors="surrogateescape")


# flat-value types the non-recursive encode fast path may emit verbatim
_SCALARS = (str, int, float, bool, type(None))


class Quantized:
    """Marker: serialize this float array as per-row int8 + f32 scales
    (the {"dcn_payload": "int8"} transport encoding, host numpy)."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = np.asarray(arr, np.float32)


class QuantizedBlockwise:
    """A float array already quantized for the v3 wire: int8 run `q`
    (truncated to the array's size), one f32 absmax scale per contiguous
    16384-element block `s`, and the array's `shape`."""

    __slots__ = ("q", "s", "shape")

    def __init__(self, *, q, s, shape):
        self.q, self.s, self.shape = q, s, tuple(shape)


def quantize_tree(obj: Any, device: DeviceLike = None):
    """Pre-encode pass for the v3 wire: every non-empty float32 ndarray
    in the diff pytree becomes a QuantizedBlockwise, quantized by the
    kernel on `device` (None: cuda); ints, bools, bytes and scalars stay
    exact.
    Returns (wrapped_obj, stats):

      raw  — f32 bytes the wrapped tensors would have cost on the wire
      wire — int8 + scale bytes they cost instead
      errs — per-tensor mean |x - dq(q(x))| / mean |x|
      max_abs_err — sum over tensors of max |x - dq(q(x))|: a per-element
             bound on what this quantization can move any downstream fold
    """
    dev = resolve_device(device)
    stats = {"raw": 0, "wire": 0, "errs": [], "max_abs_err": 0.0}

    def walk(o):
        if isinstance(o, np.ndarray) and o.dtype == np.float32 and o.size:
            x = torch.from_numpy(np.ascontiguousarray(o)).to(dev)
            q, s = quantize_blockwise(x)
            stats["raw"] += o.size * 4
            stats["wire"] += q.numel() + 4 * s.numel()
            mean_abs = float(x.abs().mean())
            if mean_abs > 0.0:
                err = (x - dequantize_blockwise(q, s, o.shape)).abs()
                stats["errs"].append(float(err.mean()) / mean_abs)
                stats["max_abs_err"] += float(err.max())
            return QuantizedBlockwise(q=q.cpu().numpy(), s=s.cpu().numpy(),
                                      shape=o.shape)
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [walk(v) for v in o]
        return o

    return walk(obj), stats


def wire_size(obj: Any) -> int:
    """Approximate serialized size of an encode()d payload (the same
    leaf-walking estimate as the JAX codec)."""
    n = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        t = type(o)
        if t is dict:
            n += 3
            for k, v in o.items():
                stack.append(k)
                stack.append(v)
        elif t is list or t is tuple:
            n += 3
            stack.extend(o)
        elif t is bytes or t is bytearray:
            n += len(o) + 5
        elif t is str:
            n += len(o) + 5
        elif t is bool or o is None:
            n += 1
        elif t is int:
            n += 5
        elif t is float:
            n += 9
        elif isinstance(o, np.ndarray):
            n += o.nbytes + 8
        else:
            n += 8
    return n


def quant_estimate(obj: Any) -> "tuple[int, int]":
    """(raw_bytes, quantized_bytes) the float32 tensors of a DECODED
    pytree cost in f32 and in blockwise-int8 form: the MIX master's
    estimate for gathered diffs, whose tensors it sees dequantized."""
    raw = q = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, np.ndarray):
            if o.dtype == np.float32 and o.size:
                raw += o.size * 4
                q += o.size + 4 * ((o.size + _BLOCK - 1) // _BLOCK)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
    return raw, q


def _nd(a: np.ndarray) -> dict:
    return {"__nd__": [str(a.dtype), list(a.shape),
                       np.ascontiguousarray(a).tobytes()]}


def encode(obj: Any) -> Any:
    if type(obj) is dict:
        # non-recursive fast path for FLAT dicts of ndarrays/bytes/scalars
        out = {}
        for k, v in obj.items():
            t = type(v)
            if t is np.ndarray:
                out[k] = _nd(v)
            elif t is bytes:
                out[k] = {"__by__": v}
            elif t in _SCALARS:
                out[k] = v
            else:
                break
        else:
            return out
    if isinstance(obj, Quantized):
        a = obj.arr
        if a.size == 0:
            return {"__nd__": [str(a.dtype), list(a.shape), b""]}
        rows = a.reshape(a.shape[0] if a.ndim > 1 else 1, -1)
        scale = np.maximum(np.abs(rows).max(axis=1), 1e-30) / 127.0
        q = np.clip(np.round(rows / scale[:, None]), -127, 127).astype(np.int8)
        return {"__ndq__": [list(a.shape), scale.astype(np.float32).tobytes(),
                            q.tobytes()]}
    if isinstance(obj, QuantizedBlockwise):
        return {"__ndq3__": [list(obj.shape), obj.s.tobytes(),
                             obj.q.tobytes()]}
    if isinstance(obj, np.ndarray):
        return _nd(obj)
    if isinstance(obj, bytes):
        # the old-spec wire has no bin type: tag raw blobs
        return {"__by__": obj}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    return obj


def decode(obj: Any, device: DeviceLike = None) -> Any:
    """Inverse of encode; v3 tensors are dequantized by the kernel on
    `device` (None: cuda) and returned as host float32 arrays.  A body
    without v3 tensors touches no device."""
    if isinstance(obj, dict):
        if "__nd__" in obj and len(obj) == 1:
            dtype, shape, raw = obj["__nd__"]
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            return np.frombuffer(to_bytes(raw), dtype=np.dtype(dtype)
                                 ).reshape(shape).copy()
        if "__by__" in obj and len(obj) == 1:
            return to_bytes(obj["__by__"])
        if "__ndq__" in obj and len(obj) == 1:
            shape, scales, q = obj["__ndq__"]
            scale = np.frombuffer(to_bytes(scales), np.float32)
            rows = np.frombuffer(to_bytes(q), np.int8).reshape(len(scale), -1)
            return (rows.astype(np.float32) * scale[:, None]).reshape(shape)
        if "__ndq3__" in obj and len(obj) == 1:
            shape, scales, q = obj["__ndq3__"]
            dev = resolve_device(device)
            qt = torch.from_numpy(np.frombuffer(to_bytes(q), np.int8).copy())
            st = torch.from_numpy(
                np.frombuffer(to_bytes(scales), np.float32).copy())
            return dequantize_blockwise(qt.to(dev), st.to(dev),
                                        shape).cpu().numpy()
        return {(k.decode() if isinstance(k, bytes) else k): decode(v, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [decode(v, device) for v in obj]
    return obj
