"""Replica and shard layouts (counterpart of jubatus_tpu/parallel/mesh.py).

The JAX package lays a process's devices out as a (dp, shard) mesh: each
dp slot holds a full model replica that trains on its own slice of a
microbatch and reconciles by an all-reduce, and each shard slot holds the
rows of one key-hash range (parallel/sharded.py, sharded_rows.py).  The
port keeps every replica and every shard on ONE torch device: a replica
is a slice of a stacked [ndp, ...] tensor and a shard a slab of a stacked
[nshard, ...] table, not a device, so any number of either fits a card
(memory permitting); the all-reduce is device arithmetic along the
stacked axis (parallel/collective.py), and a shard's sweep is one launch
over its slab.  A layout has replicas or shards, not both: no driver
does the 2-D grid (the JAX server refuses it too).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from jubatus_tpu_torch.device import DeviceLike, resolve_device

GRID_REFUSAL = ("--dp_replicas and --shard_devices are mutually exclusive "
                "(a 2-D (dp, shard) grid needs a driver that does both)")


@dataclass(frozen=True)
class Mesh:
    """ndp replicas, or nshard shards, stacked on `device`."""

    ndp: int
    device: torch.device
    nshard: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.ndp, "shard": self.nshard}


def local_device_count(device: DeviceLike = None) -> int:
    """The devices a process could spread replicas or shards over: the
    CUDA cards for a cuda device, 1 for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_mesh(dp: Optional[int] = None, shard: int = 1,
              device: DeviceLike = None) -> Mesh:
    """`dp` replicas (None: one a local device, or one with shards) or
    `shard` shards on `device` (None: cuda).  A count above the device
    count stacks that many on the one device."""
    dev = resolve_device(device)
    nshard = int(shard)
    if nshard < 1:
        raise ValueError(f"shard({nshard}) must be >= 1")
    if dp is None:
        ndp = 1 if nshard > 1 else local_device_count(dev)
    else:
        ndp = int(dp)
    if ndp < 1:
        raise ValueError(f"dp({ndp}) must be >= 1")
    if ndp > 1 and nshard > 1:
        raise ValueError(GRID_REFUSAL)
    return Mesh(ndp, dev, nshard)


def resolve_replicas(flag: str, value: int, device: DeviceLike = None) -> int:
    """--dp_replicas or --shard_devices to a count (the JAX server's
    _resolve_devices, jubatus_tpu/framework/server_base.py:311-320): 0 is
    one a local device, as JAX resolves it to its devices; a negative
    value raises JAX's message.  Where JAX refuses a count above its
    devices, the port stacks that many replicas or shards on the one
    card."""
    if value < 0:
        raise ValueError(f"--{flag} must be >= 0, got {value}")
    return value or local_device_count(device)
