"""Replica layouts (counterpart of jubatus_tpu/parallel/mesh.py).

The JAX package lays a process's devices out as a (dp, shard) mesh: each
dp slot holds a full model replica that trains on its own slice of a
microbatch and reconciles by an all-reduce.  The port keeps every replica
on ONE torch device: a replica is a slice of a stacked [ndp, ...] tensor,
not a device, so any number of replicas fits a card (memory permitting)
and the all-reduce is device arithmetic along the stacked axis
(parallel/collective.py).  The shard axis is 1: key sharding over devices
is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from jubatus_tpu_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """ndp replicas stacked on `device`."""

    ndp: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.ndp, "shard": 1}


def local_device_count(device: DeviceLike = None) -> int:
    """The devices a process could spread replicas over: the CUDA cards
    for a cuda device, 1 for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_mesh(dp: Optional[int] = None, shard: int = 1,
              device: DeviceLike = None) -> Mesh:
    """`dp` replicas (None: one a local device) on `device` (None: cuda).
    A dp above the device count stacks that many replicas on the one
    device."""
    if shard != 1:
        raise ValueError("a shard axis above 1 is the sharded tier: ROADMAP "
                         "Queue 1 item 6")
    dev = resolve_device(device)
    ndp = local_device_count(dev) if dp is None else int(dp)
    if ndp < 1:
        raise ValueError(f"dp({ndp}) must be >= 1")
    return Mesh(ndp, dev)


def resolve_replicas(flag: str, value: int, device: DeviceLike = None) -> int:
    """--dp_replicas to a replica count (the JAX server's _resolve_devices,
    jubatus_tpu/framework/server_base.py:311-320): 0 is one replica a local
    device, as JAX resolves it to its devices; a negative value raises
    JAX's message.  Where JAX refuses a count above its devices, the port
    stacks that many replicas on the one card."""
    if value < 0:
        raise ValueError(f"--{flag} must be >= 0, got {value}")
    return value or local_device_count(device)
