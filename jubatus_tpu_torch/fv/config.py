"""converter_config parsing (copy of jubatus_tpu/fv/config.py).

Schema-compatible with the reference's fv_converter JSON block (the
"converter" section of every config shipped with Jubatus):
string_filter_types/rules, num_filter_types/rules, string_types/rules,
num_types/rules, binary_types/rules, combination_types/rules, hash_max_size.

Key matchers follow jubatus semantics: "" and "*" match everything,
"pre*" is a prefix match, "*suf" a suffix match, "/re/" a regex, anything
else an exact match.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DEFAULT_DIM = 1 << 20  # fixed hashed feature space (power of two)


class KeyMatcher:
    def __init__(self, pattern: str):
        self.pattern = pattern
        if pattern in ("", "*"):
            self._fn = lambda k: True
        elif len(pattern) >= 2 and pattern.startswith("/") and pattern.endswith("/"):
            rx = re.compile(pattern[1:-1])
            self._fn = lambda k: rx.search(k) is not None
        elif pattern.endswith("*"):
            pre = pattern[:-1]
            self._fn = lambda k: k.startswith(pre)
        elif pattern.startswith("*"):
            suf = pattern[1:]
            self._fn = lambda k: k.endswith(suf)
        else:
            self._fn = lambda k: k == pattern

    def matches(self, key: str) -> bool:
        return self._fn(key)


@dataclass
class StringRule:
    matcher: KeyMatcher
    type: str                 # "str", "space", "ngram", or a name in string_types
    sample_weight: str = "bin"   # bin | tf | log_tf
    global_weight: str = "bin"   # bin | idf | bm25 | weight
    except_: Optional[KeyMatcher] = None


@dataclass
class NumRule:
    matcher: KeyMatcher
    type: str                 # "num", "log", "str", or a name in num_types


@dataclass
class FilterRule:
    matcher: KeyMatcher
    type: str
    suffix: str = ""


@dataclass
class BinaryRule:
    matcher: KeyMatcher
    type: str


@dataclass
class CombinationRule:
    matcher_left: KeyMatcher
    matcher_right: KeyMatcher
    type: str                 # "mul" | "add" | name in combination_types


@dataclass
class ConverterConfig:
    string_filter_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    string_filter_rules: List[FilterRule] = field(default_factory=list)
    num_filter_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    num_filter_rules: List[FilterRule] = field(default_factory=list)
    string_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    string_rules: List[StringRule] = field(default_factory=list)
    num_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    num_rules: List[NumRule] = field(default_factory=list)
    binary_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    binary_rules: List[BinaryRule] = field(default_factory=list)
    combination_types: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    combination_rules: List[CombinationRule] = field(default_factory=list)
    dim: int = DEFAULT_DIM    # from "hash_max_size" (rounded up to pow2)

    @classmethod
    def from_json(cls, obj: Optional[Dict[str, Any]]) -> "ConverterConfig":
        obj = obj or {}
        cfg = cls()
        cfg.string_filter_types = dict(obj.get("string_filter_types") or {})
        cfg.num_filter_types = dict(obj.get("num_filter_types") or {})
        cfg.string_types = dict(obj.get("string_types") or {})
        cfg.num_types = dict(obj.get("num_types") or {})
        cfg.binary_types = dict(obj.get("binary_types") or {})
        cfg.combination_types = dict(obj.get("combination_types") or {})

        for r in obj.get("string_filter_rules") or []:
            cfg.string_filter_rules.append(
                FilterRule(KeyMatcher(r["key"]), r["type"], r.get("suffix", "")))
        for r in obj.get("num_filter_rules") or []:
            cfg.num_filter_rules.append(
                FilterRule(KeyMatcher(r["key"]), r["type"], r.get("suffix", "")))
        for r in obj.get("string_rules") or []:
            cfg.string_rules.append(StringRule(
                matcher=KeyMatcher(r["key"]),
                type=r["type"],
                sample_weight=r.get("sample_weight", "bin"),
                global_weight=r.get("global_weight", "bin"),
                except_=KeyMatcher(r["except"]) if "except" in r else None,
            ))
        for r in obj.get("num_rules") or []:
            cfg.num_rules.append(NumRule(KeyMatcher(r["key"]), r["type"]))
        for r in obj.get("binary_rules") or []:
            cfg.binary_rules.append(BinaryRule(KeyMatcher(r["key"]), r["type"]))
        for r in obj.get("combination_rules") or []:
            cfg.combination_rules.append(CombinationRule(
                KeyMatcher(r["key_left"]), KeyMatcher(r["key_right"]), r["type"]))

        hms = obj.get("hash_max_size")
        if hms:
            dim = 1
            while dim < int(hms):
                dim <<= 1
            cfg.dim = dim
        return cfg
