"""Stable feature hashing (copy of jubatus_tpu/fv/hashing.py, pure Python).

Every feature key is hashed with FNV-1a 64 into [0, dim), identical to the
JAX package's native and Python paths.  Feature keys repeat heavily in a
stream, so hash_feature memoises a bounded number of recent keys; the
result is the same function of (key, dim) either way.
"""

from __future__ import annotations

import functools

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


@functools.lru_cache(maxsize=1 << 18)
def hash_feature(key: str, dim: int) -> int:
    """Map a feature-key string into [0, dim). dim must be a power of two."""
    return fnv1a64(key.encode("utf-8", "surrogateescape")) & (dim - 1)


def hash_u64(key: str) -> int:
    return fnv1a64(key.encode("utf-8", "surrogateescape"))
