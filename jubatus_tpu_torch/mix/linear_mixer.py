"""MIX wire encoding of a diff body (counterpart of encode_wire_diff in
jubatus_tpu/mix/linear_mixer.py).

Only the encode step is in this slice; the rounds, peers and coordinator
of LinearMixer are later work.  A round over two in-process drivers reads:

    dev = drv.device
    body = encode_wire_diff(drv.encode_diff(drv.get_diff()), True, dev)
    diff = codec.decode(codec.unpackb(codec.packb(body)), dev)
    merged = ClassifierDriver.mix(diff_a, diff_b)
    ... encode_wire_diff(merged, True, dev) -> decode -> drv.put_diff(...)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from jubatus_tpu_torch.device import DeviceLike
from jubatus_tpu_torch.mix import codec


def encode_wire_diff(diff, quantize: bool, device: DeviceLike = None,
                     stats: Optional[Dict[str, Any]] = None) -> Any:
    """codec-encode a diff body for the wire.  With quantization on, every
    f32 tensor travels as blockwise int8 + absmax scales, quantized by the
    kernel on `device` (None: cuda, which raises without a card; pass the
    driver's device); off, the bytes are the exact v2 encoding.  When
    `stats` is given, this encode's byte counts and roundtrip errors are
    added to it ("raw", "wire", "max_abs_err", "errs") — the values the
    JAX mixer feeds to its metrics registry."""
    if not quantize:
        return codec.encode(diff)
    qdiff, st = codec.quantize_tree(diff, device)
    if stats is not None:
        for key in ("raw", "wire", "max_abs_err"):
            stats[key] = stats.get(key, 0) + st[key]
        stats.setdefault("errs", []).extend(st["errs"])
    return codec.encode(qdiff)
