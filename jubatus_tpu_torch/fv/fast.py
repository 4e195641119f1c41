"""Fast-path eligibility and compilation for the native wire converter
(counterpart of jubatus_tpu/fv/fast.py, with the same eligibility rules).

The C FastConverter (native/_fastconv.c) covers the common converter
configs: plain key matchers, str/space/ngram splitters, bin/tf/log_tf
sample weights, bin global weights, num/log/str numeric features.
Anything outside that (regex matchers, filters, idf/bm25 global weights,
combination rules, binary rules, and "dynamic" plugins, fv/plugin.py)
gets None and trains through the Python DatumToFVConverter, the
semantics reference — the reference server's routing, as in the JAX
package.

A compiled FastConverter exposes two wire entry points:

  convert(buf, params_off, mode)          one request -> padded buffers
  convert_raw_batch(frames, mode[, acquire])
                                          N train frames -> ONE packed
                                          [idx|val|aux|mask] arena in a
                                          single GIL-released call
"""

from __future__ import annotations

from typing import Optional

from jubatus_tpu_torch import native
from jubatus_tpu_torch.fv.config import ConverterConfig

# matcher kinds (must match the M_* enum in _fastconv.c)
_M_ALL, _M_PREFIX, _M_SUFFIX, _M_EXACT = 0, 1, 2, 3
_SPLITS = {"str": 0, "space": 1, "ngram": 2}
_SAMPLES = {"bin": 0, "tf": 1, "log_tf": 2}
_NUMS = {"num": 0, "log": 1, "str": 2}


def _compile_matcher(pattern: str):
    if pattern in ("", "*"):
        return (_M_ALL, b"")
    if len(pattern) >= 2 and pattern.startswith("/") and pattern.endswith("/"):
        return None  # regex: Python path
    if pattern.endswith("*"):
        return (_M_PREFIX, pattern[:-1].encode())
    if pattern.startswith("*"):
        return (_M_SUFFIX, pattern[1:].encode())
    return (_M_EXACT, pattern.encode())


def build_fast_spec(config: ConverterConfig,
                    k_buckets, b_buckets) -> Optional[dict]:
    """The FastConverter spec for `config`, or None where the config needs
    the Python converter."""
    if (config.string_filter_rules or config.num_filter_rules
            or config.binary_rules or config.combination_rules):
        return None
    srules = []
    for r in config.string_rules:
        if r.except_ is not None or r.global_weight != "bin":
            return None
        if r.sample_weight not in _SAMPLES:
            return None
        m = _compile_matcher(r.matcher.pattern)
        if m is None:
            return None
        tdef = config.string_types.get(r.type, {"method": r.type})
        method = tdef.get("method", r.type)
        if method not in _SPLITS:
            return None
        char_num = int(tdef.get("char_num", 2))
        if method == "ngram" and char_num <= 0:
            return None
        suffix = f"@{r.type}#{r.sample_weight}/{r.global_weight}".encode()
        srules.append((m[0], m[1], _SPLITS[method], char_num,
                       _SAMPLES[r.sample_weight], suffix))
    nrules = []
    for r in config.num_rules:
        m = _compile_matcher(r.matcher.pattern)
        if m is None:
            return None
        tdef = config.num_types.get(r.type, {"method": r.type})
        method = tdef.get("method", r.type)
        if method not in _NUMS:
            return None
        nrules.append((m[0], m[1], _NUMS[method]))
    return {
        "dim": config.dim,
        "string_rules": srules,
        "num_rules": nrules,
        "k_buckets": list(k_buckets),
        "b_buckets": list(b_buckets),
    }


def make_fast_converter(config: ConverterConfig, k_buckets, b_buckets):
    """FastConverter for the config (the native extension is built on the
    first call), or None if the config is ineligible."""
    spec = build_fast_spec(config, k_buckets, b_buckets)
    if spec is None:
        return None
    return native.load().FastConverter(spec)
