"""DatumToFVConverter: datum -> fixed-shape hashed sparse batches.

Copy of jubatus_tpu/fv/converter.py on its pure-Python path (the JAX
package falls back to it when the native packer is absent).  Feature keys
follow the reference naming convention ("key$value@type#sample/global",
"key@num") and are hashed into [0, dim); batches are padded (indices,
values) arrays whose zero-valued padding entries (index 0) are no-ops for
gather-dot and scatter-add.  from_rows keeps each row's dict-order column
layout, so a batch is laid out exactly as the JAX package lays it out.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jubatus_tpu_torch.fv.config import ConverterConfig
from jubatus_tpu_torch.fv.datum import Datum
from jubatus_tpu_torch.fv.hashing import fnv1a64, hash_feature
from jubatus_tpu_torch.fv.weight_manager import WeightManager

# K (padded nnz per datum) is bucketed like the JAX package's batches.
_K_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# plugin registries (python callables registered by name); the port's
# plugin loader is later work, so they stay empty unless a caller fills
# them
STRING_FEATURE_PLUGINS: Dict[str, Callable[[Dict, str], List[Tuple[str, int]]]] = {}
NUM_FEATURE_PLUGINS: Dict[str, Callable[[Dict, str, float], List[Tuple[str, float]]]] = {}
STRING_FILTER_PLUGINS: Dict[str, Callable[[Dict, str], str]] = {}
NUM_FILTER_PLUGINS: Dict[str, Callable[[Dict, float], float]] = {}
BINARY_FEATURE_PLUGINS: Dict[str, Callable[[Dict, str, bytes], List[Tuple[str, float]]]] = {}


def _round_k(k: int) -> int:
    for b in _K_BUCKETS:
        if k <= b:
            return b
    return ((k + 4095) // 4096) * 4096


class SparseBatch:
    """A batch of hashed sparse vectors: indices [B,K] int32, values [B,K] f32.

    Padding entries carry value 0.0 (index 0), making them no-ops for both
    gather-dot (0 * w == 0) and scatter-add (w += 0).
    """

    __slots__ = ("indices", "values")

    def __init__(self, indices: np.ndarray, values: np.ndarray):
        self.indices = indices
        self.values = values

    @property
    def batch_size(self) -> int:
        return self.indices.shape[0]

    def pad_to(self, b: int) -> "SparseBatch":
        """Pad the batch dimension to b rows (zero-valued no-op rows)."""
        cur = self.indices.shape[0]
        if cur >= b:
            return self
        k = self.indices.shape[1]
        indices = np.zeros((b, k), dtype=np.int32)
        values = np.zeros((b, k), dtype=np.float32)
        indices[:cur] = self.indices
        values[:cur] = self.values
        return SparseBatch(indices, values)

    @classmethod
    def from_rows(cls, rows: Sequence[Dict[int, float]], k_hint: int = 0) -> "SparseBatch":
        b = max(len(rows), 1)
        k = _round_k(max(k_hint, max((len(r) for r in rows), default=1), 1))
        indices = np.zeros((b, k), dtype=np.int32)
        values = np.zeros((b, k), dtype=np.float32)
        for i, row in enumerate(rows):
            if not row:
                continue
            idx = np.fromiter(row.keys(), dtype=np.int32, count=len(row))
            val = np.fromiter(row.values(), dtype=np.float32, count=len(row))
            indices[i, : len(row)] = idx
            values[i, : len(row)] = val
        return cls(indices, values)


# -- splitters ---------------------------------------------------------------

def _split_tokens(type_name: str, params: Dict, value: str) -> List[Tuple[str, int]]:
    """Return [(token, count)] for a string value under the given splitter."""
    if type_name == "str":
        return [(value, 1)]
    if type_name == "space":
        counts: Dict[str, int] = {}
        for tok in value.split():
            counts[tok] = counts.get(tok, 0) + 1
        return list(counts.items())
    if type_name == "ngram":
        n = int(params.get("char_num", 2))
        counts = {}
        for i in range(max(len(value) - n + 1, 0)):
            tok = value[i : i + n]
            counts[tok] = counts.get(tok, 0) + 1
        return list(counts.items())
    if type_name == "regexp":
        rx = re.compile(params["pattern"])
        grp = int(params.get("group", 0))
        counts = {}
        for m in rx.finditer(value):
            tok = m.group(grp)
            counts[tok] = counts.get(tok, 0) + 1
        return list(counts.items())
    raise ValueError(f"unknown string feature type: {type_name}")


def _sample_weight(kind: str, tf: int) -> float:
    # tf is the raw occurrence count (Jubatus fv_convert semantics)
    if kind == "bin":
        return 1.0
    if kind == "tf":
        return float(tf)
    if kind == "log_tf":
        return math.log(1.0 + tf)
    raise ValueError(f"unknown sample_weight: {kind}")


class DatumToFVConverter:
    def __init__(self, config: ConverterConfig, keep_revert: bool = False):
        self.config = config
        self.dim = config.dim
        self.weights = WeightManager(config.dim)
        self.keep_revert = keep_revert
        # index -> feature key string; only maintained when keep_revert
        # (recommender decode_row / jubaconv need it; classifier does not)
        self.revert_dict: Dict[int, str] = {}

    # -- single-datum extraction (host side) -------------------------------

    def _apply_string_filters(self, pairs: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
        out = list(pairs)
        for rule in self.config.string_filter_rules:
            tdef = self.config.string_filter_types.get(rule.type, {"method": rule.type})
            method = tdef.get("method", rule.type)
            # scan outputs of earlier rules too, so filters chain
            for k, v in list(out):
                if not rule.matcher.matches(k):
                    continue
                if method == "regexp":
                    fv = re.sub(tdef["pattern"], tdef.get("replace", ""), v)
                elif method in STRING_FILTER_PLUGINS:
                    fv = STRING_FILTER_PLUGINS[method](tdef, v)
                else:
                    raise ValueError(f"unknown string filter: {method}")
                out.append((k + rule.suffix, fv))
        return out

    def _apply_num_filters(self, pairs: List[Tuple[str, float]]) -> List[Tuple[str, float]]:
        out = list(pairs)
        for rule in self.config.num_filter_rules:
            tdef = self.config.num_filter_types.get(rule.type, {"method": rule.type})
            method = tdef.get("method", rule.type)
            for k, v in list(out):
                if not rule.matcher.matches(k):
                    continue
                if method == "add":
                    fv = v + float(tdef.get("value", 0))
                elif method == "linear_normalization":
                    lo, hi = float(tdef["min"]), float(tdef["max"])
                    fv = (v - lo) / max(hi - lo, 1e-12)
                elif method == "gaussian_normalization":
                    fv = (v - float(tdef["average"])) / max(float(tdef["standard_deviation"]), 1e-12)
                elif method == "sigmoid_normalization":
                    fv = 1.0 / (1.0 + math.exp(-float(tdef.get("gain", 1)) * (v - float(tdef.get("bias", 0)))))
                elif method in NUM_FILTER_PLUGINS:
                    fv = NUM_FILTER_PLUGINS[method](tdef, v)
                else:
                    raise ValueError(f"unknown num filter: {method}")
                out.append((k + rule.suffix, fv))
        return out

    def extract(self, datum: Datum) -> List[Tuple[str, float, str]]:
        """Return [(feature_key, sample_value, global_weight_kind)]."""
        feats: List[Tuple[str, float, str]] = []
        svals = self._apply_string_filters(datum.string_values)
        nvals = self._apply_num_filters(datum.num_values)

        for k, v in nvals:
            for rule in self.config.num_rules:
                if not rule.matcher.matches(k):
                    continue
                tdef = self.config.num_types.get(rule.type, {"method": rule.type})
                method = tdef.get("method", rule.type)
                if method == "num":
                    feats.append((f"{k}@num", float(v), "bin"))
                elif method == "log":
                    feats.append((f"{k}@log", math.log(max(1.0, v)), "bin"))
                elif method == "str":
                    feats.append((f"{k}${v:g}@str", 1.0, "bin"))
                elif method in NUM_FEATURE_PLUGINS:
                    for fk, fval in NUM_FEATURE_PLUGINS[method](tdef, k, v):
                        feats.append((fk, fval, "bin"))
                else:
                    raise ValueError(f"unknown num feature type: {method}")

        for k, v in svals:
            for rule in self.config.string_rules:
                if not rule.matcher.matches(k):
                    continue
                if rule.except_ is not None and rule.except_.matches(k):
                    continue
                tdef = self.config.string_types.get(rule.type, {"method": rule.type})
                method = tdef.get("method", rule.type)
                if method in STRING_FEATURE_PLUGINS:
                    toks = STRING_FEATURE_PLUGINS[method](tdef, v)
                else:
                    toks = _split_tokens(method, tdef, v)
                for tok, tf in toks:
                    key = f"{k}${tok}@{rule.type}#{rule.sample_weight}/{rule.global_weight}"
                    feats.append((key, _sample_weight(rule.sample_weight, tf), rule.global_weight))

        for k, v in datum.binary_values:
            for rule in self.config.binary_rules:
                if not rule.matcher.matches(k):
                    continue
                tdef = self.config.binary_types.get(rule.type, {"method": rule.type})
                method = tdef.get("method", rule.type)
                if method in BINARY_FEATURE_PLUGINS:
                    for fk, fval in BINARY_FEATURE_PLUGINS[method](tdef, k, v):
                        feats.append((fk, fval, "bin"))
                else:  # hash raw bytes as a presence feature (stable across processes)
                    feats.append((f"{k}@bin${fnv1a64(v):x}", 1.0, "bin"))

        if self.config.combination_rules:
            base = list(feats)
            for rule in self.config.combination_rules:
                tdef = self.config.combination_types.get(rule.type, {"method": rule.type})
                method = tdef.get("method", rule.type)
                for lk, lv, _ in base:
                    if not rule.matcher_left.matches(lk):
                        continue
                    for rk, rv, _ in base:
                        if lk == rk or not rule.matcher_right.matches(rk):
                            continue
                        if method == "mul":
                            cv = lv * rv
                        elif method == "add":
                            cv = lv + rv
                        else:
                            raise ValueError(f"unknown combination type: {method}")
                        feats.append((f"{lk}&{rk}", cv, "bin"))
        return feats

    # -- hashed conversion --------------------------------------------------

    def convert_row(self, datum: Datum, update_weights: bool = False) -> Dict[int, float]:
        """Convert one datum to {hashed_index: value} with global weights applied."""
        feats = self.extract(datum)
        row: Dict[int, float] = {}
        needs_global: List[Tuple[int, float, str]] = []
        for key, val, gw in feats:
            idx = hash_feature(key, self.dim)
            if self.keep_revert and idx not in self.revert_dict:
                self.revert_dict[idx] = key
            if gw == "bin":
                row[idx] = row.get(idx, 0.0) + val
            else:
                needs_global.append((idx, val, gw))
        if update_weights:
            uniq = {i for i, _, _ in needs_global} | set(row.keys())
            self.weights.update(np.fromiter(uniq, dtype=np.int64, count=len(uniq)))
        if needs_global:
            # one vectorized lookup per weight kind, not one per feature
            by_kind: Dict[str, List[Tuple[int, float]]] = {}
            for idx, val, gw in needs_global:
                by_kind.setdefault(gw, []).append((idx, val))
            for gw, pairs in by_kind.items():
                idx_arr = np.fromiter((i for i, _ in pairs), dtype=np.int64, count=len(pairs))
                ws = self.weights.global_weight(idx_arr, gw)
                for (idx, val), w in zip(pairs, ws):
                    row[idx] = row.get(idx, 0.0) + val * float(w)
        return row

    def convert_batch(self, datums: Sequence[Datum], update_weights: bool = False,
                      k_hint: int = 0) -> SparseBatch:
        rows = [self.convert_row(d, update_weights=update_weights) for d in datums]
        return SparseBatch.from_rows(rows, k_hint=k_hint)

    # -- revert (decode_row / jubaconv debugging) ---------------------------

    def revert_feature(self, index: int) -> Optional[Tuple[str, object]]:
        """Best-effort inverse: hashed index -> (datum key, value)."""
        key = self.revert_dict.get(index)
        if key is None:
            return None
        if key.endswith("@num"):
            return (key[:-4], None)  # numeric value itself is not invertible
        m = re.match(r"^(.*)\$(.*)@(.*?)(#.*)?$", key)
        if m:
            return (m.group(1), m.group(2))
        return (key, None)
