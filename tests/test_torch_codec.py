"""The port's MIX codec (jubatus_tpu_torch/mix/codec.py, linear_mixer.py)
against the JAX package's: the bytes a diff costs on the wire must be the
same from either package, so a port server and a JAX server can mix.

encode_wire_diff(quantize=True) runs the port's quantizer wrapper on the
CPU here (its plain version); on the card the CUDA kernel produces the
same bytes (chip_smoke.py holds the two against each other bitwise).
"""

import numpy as np
import pytest
import torch

from jubatus_tpu.mix import codec as jcodec
from jubatus_tpu.mix.linear_mixer import encode_wire_diff as jencode
from jubatus_tpu_torch.mix import codec as tcodec
from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff as tencode

# the suite's files run side by side in worker processes: one intra-op
# thread keeps these small tensors from contending for the cores
torch.set_num_threads(1)


def make_diff(seed, labels=4, cols=3000, with_cov=True):
    """A column-sparse classifier diff shaped like get_diff's."""
    rng = np.random.default_rng(seed)
    diff = {
        "labels": [f"c{i}" for i in range(labels)],
        "dim": 1 << 16,
        "cols": np.sort(rng.choice(1 << 16, cols, replace=False)
                        ).astype(np.int32),
        "counts": rng.integers(0, 50, labels).astype(np.int32),
        "k": 1,
        "weights": {"cols": np.arange(5, dtype=np.int32),
                    "vals": rng.integers(0, 9, 5).astype(np.int32),
                    "doc_count": 7},
        "w": (rng.standard_normal((labels, cols)) * 0.05).astype(np.float32),
    }
    if with_cov:
        diff["cov"] = -(rng.random((labels, cols)) * 0.3).astype(np.float32)
    return diff


DIFFS = {
    "small": make_diff(1),                          # under one block
    "partial": make_diff(2, labels=3, cols=20000),  # 4 blocks, last partial
    "no_cov": make_diff(3, with_cov=False),
    "empty": make_diff(4, labels=2, cols=0),
}


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(DIFFS))
@pytest.mark.parametrize("quantize", [True, False])
def test_wire_bytes_identical_across_packages(name, quantize):
    diff = DIFFS[name]
    raw_j = jcodec.packb(jencode(diff, quantize))
    raw_t = tcodec.packb(tencode(diff, quantize, "cpu"))
    assert raw_t == raw_j


@pytest.mark.parametrize("name", sorted(DIFFS))
@pytest.mark.parametrize("quantize", [True, False])
def test_decode_identical_across_packages(name, quantize):
    wire = jcodec.unpackb(jcodec.packb(jencode(DIFFS[name], quantize)))
    assert_tree_equal(tcodec.decode(wire, "cpu"), jcodec.decode(wire))


@pytest.mark.parametrize("name", ["small", "partial"])
def test_quantize_stats_match_jax(name):
    """Byte accounting is exact; the error statistics are float means
    taken in another order, so they agree within tolerance."""
    _, sj = jcodec.quantize_tree(DIFFS[name])
    _, st = tcodec.quantize_tree(DIFFS[name], "cpu")
    assert (st["raw"], st["wire"]) == (sj["raw"], sj["wire"])
    assert st["raw"] / st["wire"] > 3.9
    np.testing.assert_allclose(st["max_abs_err"], sj["max_abs_err"],
                               rtol=1e-6)
    np.testing.assert_allclose(st["errs"], sj["errs"], rtol=1e-5)


def test_encode_wire_diff_accumulates_stats():
    stats = {}
    for name in ("small", "partial"):
        tencode(DIFFS[name], True, "cpu", stats)
    _, a = tcodec.quantize_tree(DIFFS["small"], "cpu")
    _, b = tcodec.quantize_tree(DIFFS["partial"], "cpu")
    assert stats["raw"] == a["raw"] + b["raw"]
    assert stats["wire"] == a["wire"] + b["wire"]
    assert len(stats["errs"]) == len(a["errs"]) + len(b["errs"])


def test_per_row_int8_payload_identical_across_packages():
    """The {"dcn_payload": "int8"} transport (codec.Quantized) too."""
    diff = dict(DIFFS["small"])
    jdiff = {**diff, "w": jcodec.Quantized(diff["w"]),
             "cov": jcodec.Quantized(diff["cov"])}
    tdiff = {**diff, "w": tcodec.Quantized(diff["w"]),
             "cov": tcodec.Quantized(diff["cov"])}
    raw = jcodec.packb(jcodec.encode(jdiff))
    assert tcodec.packb(tcodec.encode(tdiff)) == raw
    assert_tree_equal(tcodec.decode(tcodec.unpackb(raw), "cpu"),
                      jcodec.decode(jcodec.unpackb(raw)))


def test_tagged_bytes_and_scalars_roundtrip():
    obj = {"blob": bytes(range(256)), "n": np.int64(3), "x": np.float32(0.5),
           "nested": [{"a": np.arange(3, dtype=np.int32)}, "s", None]}
    raw = tcodec.packb(tcodec.encode(obj))
    assert raw == jcodec.packb(jcodec.encode(obj))
    back = tcodec.decode(tcodec.unpackb(raw), "cpu")
    assert back["blob"] == obj["blob"] and back["n"] == 3
    np.testing.assert_array_equal(back["nested"][0]["a"], [0, 1, 2])


@pytest.mark.parametrize("name", sorted(DIFFS))
def test_wire_size_matches_jax(name):
    enc = tencode(DIFFS[name], True, "cpu")
    assert tcodec.wire_size(enc) == jcodec.wire_size(jencode(DIFFS[name],
                                                             True))


@pytest.fixture
def no_card(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_quantized_encode_without_a_device_asks_for_cuda(no_card):
    """The quantizer runs on cuda unless the caller names the CPU: with no
    card, leaving the device out raises instead of quantizing on the host."""
    with pytest.raises(RuntimeError, match="cuda"):
        tencode(DIFFS["small"], True)
    with pytest.raises(RuntimeError, match="cuda"):
        tcodec.quantize_tree(DIFFS["small"])


def test_v3_decode_without_a_device_asks_for_cuda(no_card):
    wire = tcodec.unpackb(tcodec.packb(tencode(DIFFS["small"], True, "cpu")))
    with pytest.raises(RuntimeError, match="cuda"):
        tcodec.decode(wire)


def test_f32_wire_needs_no_device(no_card):
    """The v2 body runs no kernel, so it encodes and decodes anywhere."""
    wire = tcodec.unpackb(tcodec.packb(tencode(DIFFS["small"], False)))
    assert_tree_equal(tcodec.decode(wire), jcodec.decode(wire))
