"""The `datum` type — the universal input record (copy of
jubatus_tpu/fv/datum.py).

Wire format (msgpack) is a 3-tuple of key/value pair lists:

    [ [[skey, sval], ...], [[nkey, nval], ...], [[bkey, bval], ...] ]
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class Datum:
    string_values: List[Tuple[str, str]] = field(default_factory=list)
    num_values: List[Tuple[str, float]] = field(default_factory=list)
    binary_values: List[Tuple[str, bytes]] = field(default_factory=list)

    def add_string(self, key: str, value: str) -> "Datum":
        self.string_values.append((key, value))
        return self

    def add_number(self, key: str, value: float) -> "Datum":
        self.num_values.append((key, float(value)))
        return self

    def add_binary(self, key: str, value: bytes) -> "Datum":
        self.binary_values.append((key, value))
        return self

    def to_msgpack(self):
        return [
            [[k, v] for k, v in self.string_values],
            [[k, v] for k, v in self.num_values],
            [[k, v] for k, v in self.binary_values],
        ]

    @classmethod
    def from_msgpack(cls, obj) -> "Datum":
        if isinstance(obj, Datum):
            return obj
        s, n, b = obj[0], obj[1], obj[2] if len(obj) > 2 else []

        def _s(x):
            return x.decode("utf-8", "surrogateescape") \
                if isinstance(x, bytes) else x

        def _b(x):
            # old-spec clients send binary as raw, which the surrogateescape
            # decode turns into str; re-encoding the same way round-trips
            # the exact bytes
            if isinstance(x, bytes):
                return x
            return str(x).encode("utf-8", "surrogateescape")

        return cls(
            string_values=[(_s(k), _s(v)) for k, v in s],
            num_values=[(_s(k), float(v)) for k, v in n],
            binary_values=[(_s(k), _b(v)) for k, v in b],
        )
