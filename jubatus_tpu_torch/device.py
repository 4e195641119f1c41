"""Device resolution and fences.

Every entry point of the port takes an explicit device.  The default is
CUDA; the CPU is used only when the caller names it.  Asking for CUDA on a
machine without it raises — there is no silent fallback, so a run that
reports device numbers really ran on the device.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def device_context(device: torch.device) -> ContextManager:
    """A `with` context that makes `device` the calling thread's current
    CUDA device (kernels launch on the current device); nothing on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
