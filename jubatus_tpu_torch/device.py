"""Device resolution, fences and telemetry.

Every entry point of the port takes an explicit device.  The default is
CUDA; the CPU is used only when the caller names it.  Asking for CUDA on a
machine without it raises — there is no silent fallback, so a run that
reports device numbers really ran on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> cuda.  Raises when cuda is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev


def device_sync(device: Optional[torch.device]) -> None:
    """Block until queued work on `device` has executed (the counterpart
    of jax.block_until_ready on a model leaf, models/base.py:281-298)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def device_telemetry(device: Optional[torch.device]) -> Dict[str, float]:
    """Allocator gauges for get_status (counterpart of
    jubatus_tpu/utils/metrics.py device_telemetry); empty on the CPU."""
    if device is None or device.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    return {
        "device_count": float(torch.cuda.device_count()),
        "device_bytes_in_use": float(st.get("allocated_bytes.all.current", 0)),
        "device_peak_bytes_in_use": float(st.get("allocated_bytes.all.peak", 0)),
        "device_bytes_reserved": float(st.get("reserved_bytes.all.current", 0)),
    }
