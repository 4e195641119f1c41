"""The port's C converter and stream framer (jubatus_tpu_torch/native/)
against the JAX package's (jubatus_tpu/native/), on the CPU.

The same seeded wire frames go through both packages' FastConverter and
FrameSplitter: every result must be bitwise equal — padded buffers, label
rows, unknown-label lists, packed arenas, frame boundaries — and errors
must be raised alike.  The port's native build must raise, not fall
back, when the compiler fails.
"""

import msgpack
import numpy as np
import pytest

from jubatus_tpu.batching.arenas import ArenaPool as JaxArenaPool
from jubatus_tpu.fv.config import ConverterConfig as JaxConfig
from jubatus_tpu.fv.converter import _K_BUCKETS
from jubatus_tpu.fv.fast import build_fast_spec as jax_spec
from jubatus_tpu.fv.fast import make_fast_converter as jax_make
from jubatus_tpu.native import _jubatus_native as jax_native
from jubatus_tpu.utils.metrics import Registry
from jubatus_tpu_torch import native
from jubatus_tpu_torch.batching.arenas import ArenaPool
from jubatus_tpu_torch.batching.bucketing import B_BUCKETS
from jubatus_tpu_torch.fv.config import ConverterConfig
from jubatus_tpu_torch.fv.fast import build_fast_spec, make_fast_converter

BIN = {"sample_weight": "bin", "global_weight": "bin"}

# the bench config, every matcher kind, tf / log_tf sample weights, the
# log / str numeric rules and a unicode ngram splitter
CONFIGS = {
    "bench": {"string_rules": [{"key": "*", "type": "str", **BIN}],
              "num_rules": [{"key": "*", "type": "num"}],
              "hash_max_size": 1 << 20},
    "prefix_space_tf_log": {
        "string_rules": [{"key": "tx*", "type": "space",
                          "sample_weight": "tf", "global_weight": "bin"}],
        "num_rules": [{"key": "n*", "type": "log"}],
        "hash_max_size": 1 << 14},
    "suffix_ngram_logtf_str": {
        "string_types": {"bi": {"method": "ngram", "char_num": "2"}},
        "string_rules": [{"key": "*name", "type": "bi",
                          "sample_weight": "log_tf", "global_weight": "bin"}],
        "num_rules": [{"key": "age", "type": "str"}],
        "hash_max_size": 1 << 16},
    "exact_ngram3": {
        "string_types": {"tri": {"method": "ngram", "char_num": "3"}},
        "string_rules": [{"key": "body", "type": "tri", **BIN}],
        "num_rules": [{"key": "score", "type": "num"}],
        "hash_max_size": 1 << 12},
    "overlapping": {
        "string_rules": [
            {"key": "*", "type": "str", **BIN},
            {"key": "tx*", "type": "space", "sample_weight": "tf",
             "global_weight": "bin"},
            {"key": "*name", "type": "ngram", "sample_weight": "log_tf",
             "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}, {"key": "n*", "type": "log"},
                      {"key": "age", "type": "str"}],
        "hash_max_size": 1 << 16},
}

INELIGIBLE = {
    "regex_matcher": {"string_rules": [{"key": "/^w.*$/", "type": "str",
                                        **BIN}]},
    "regex_num_matcher": {"num_rules": [{"key": "/x/", "type": "num"}]},
    "string_filter": {
        "string_filter_types": {"dl": {"method": "regexp", "pattern": "a",
                                       "replace": ""}},
        "string_filter_rules": [{"key": "*", "type": "dl", "suffix": "-f"}],
        "string_rules": [{"key": "*", "type": "str", **BIN}]},
    "num_filter": {
        "num_filter_types": {"add1": {"method": "add", "value": "1"}},
        "num_filter_rules": [{"key": "*", "type": "add1", "suffix": "+1"}],
        "num_rules": [{"key": "*", "type": "num"}]},
    "idf": {"string_rules": [{"key": "*", "type": "str",
                              "sample_weight": "bin", "global_weight": "idf"}]},
    "bm25": {"string_rules": [{"key": "*", "type": "space",
                               "sample_weight": "tf", "global_weight": "bm25"}]},
    "combination": {
        "num_rules": [{"key": "*", "type": "num"}],
        "combination_rules": [{"key_left": "*", "key_right": "*",
                               "type": "mul"}]},
    "binary": {"binary_rules": [{"key": "*", "type": "bin"}]},
    "plugin_splitter": {
        "string_types": {"mecab": {"method": "dynamic", "path": "x.so",
                                   "function": "create"}},
        "string_rules": [{"key": "*", "type": "mecab", **BIN}]},
    "regexp_splitter": {
        "string_types": {"re": {"method": "regexp", "pattern": "[a-z]+"}},
        "string_rules": [{"key": "*", "type": "re", **BIN}]},
    "except": {"string_rules": [{"key": "*", "except": "id", "type": "str",
                                 **BIN}]},
}

WORDS = ["ab", "cd", "tok", "日本", "語", "héllo", "wörld", "", " ",
         "x" * 200, "\t", "naïve", "✓✓✓", "a b  c", "𝕦𝕟𝕚"]
KEYS = ["txt", "txkey", "uname", "fname", "body", "日本語キー", "k", "tx日本"]
NUM_KEYS = ["n1", "nx", "age", "score", "number", "n日本"]
LABELS = ["alpha", "βeta", "第三", "l3"]


def wire_datum(rng):
    """One seeded wire datum [[sk, sv]...], [[nk, nv]...], [[bk, bv]...]:
    unicode keys and values, repeats, huge/tiny/negative/zero numbers,
    sometimes a binary section, sometimes empty."""
    strings = []
    for _ in range(int(rng.integers(0, 5))):
        words = [WORDS[int(rng.integers(0, len(WORDS)))]
                 for _ in range(int(rng.integers(0, 5)))]
        strings.append([KEYS[int(rng.integers(0, len(KEYS)))],
                        " ".join(words)])
    nums = []
    for _ in range(int(rng.integers(0, 4))):
        kind = int(rng.integers(0, 5))
        v = [float(rng.random()), float(rng.integers(-1000, 1000)),
             float(rng.random()) * 1e30, float(rng.random()) * 1e-30,
             0.0][kind]
        nums.append([NUM_KEYS[int(rng.integers(0, len(NUM_KEYS)))], v])
    if rng.random() < 0.2:
        return [strings, nums, [["blob", bytes(range(8))]]]
    return [strings, nums]


def request(rows, mid=1, bin_type=True):
    """A msgpack-rpc train/classify request and its params offset."""
    msg = msgpack.packb([0, mid, "train", ["c", rows]],
                        use_bin_type=bin_type)
    return msg, jax_native.parse_envelope(msg, 0)[4]


def frames_for(mode, seed, n_frames=9, max_rows=7):
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n_frames):
        rows = []
        for _ in range(int(rng.integers(0, max_rows))):
            d = wire_datum(rng)
            if mode == 0:
                rows.append([LABELS[int(rng.integers(0, len(LABELS)))], d])
            elif mode == 1:
                rows.append([float(rng.standard_normal()), d])
            else:
                rows.append(d)
        out.append(request(rows, mid=f, bin_type=bool(f % 2)))
    return out


def both_converters(cfg):
    jc = jax_make(JaxConfig.from_json(cfg), _K_BUCKETS, B_BUCKETS)
    tc = make_fast_converter(ConverterConfig.from_json(cfg), _K_BUCKETS,
                             B_BUCKETS)
    assert jc is not None and tc is not None
    return jc, tc


def test_the_port_loads_its_own_extension():
    mod = native.load()
    assert mod is not jax_native
    assert mod.__file__.startswith(str(native.BUILD_DIR))
    assert mod.__name__ == "jubatus_tpu_torch.native._jubatus_native"
    assert native.load() is mod                         # built once


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_fast_spec_equal_for_eligible_configs(cfg_name):
    cfg = CONFIGS[cfg_name]
    spec = build_fast_spec(ConverterConfig.from_json(cfg), _K_BUCKETS,
                           B_BUCKETS)
    assert spec is not None
    assert spec == jax_spec(JaxConfig.from_json(cfg), _K_BUCKETS, B_BUCKETS)


@pytest.mark.parametrize("cfg_name", sorted(INELIGIBLE))
def test_fast_spec_none_for_ineligible_configs(cfg_name):
    cfg = INELIGIBLE[cfg_name]
    assert jax_spec(JaxConfig.from_json(cfg), _K_BUCKETS, B_BUCKETS) is None
    assert build_fast_spec(ConverterConfig.from_json(cfg), _K_BUCKETS,
                           B_BUCKETS) is None
    assert make_fast_converter(ConverterConfig.from_json(cfg), _K_BUCKETS,
                               B_BUCKETS) is None


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_convert_bitwise(cfg_name, mode):
    jc, tc = both_converters(CONFIGS[cfg_name])
    # a label table that knows some labels: the rest come back unknown
    for conv in (jc, tc):
        conv.set_label_row("alpha".encode(), 3)
        conv.set_label_row("第三".encode(), 0)
    for m, o in frames_for(mode, seed=len(cfg_name) * 10 + mode):
        j = jc.convert(m, o, mode)
        t = tc.convert(m, o, mode)
        assert j[:3] == t[:3]                           # n, b, k
        assert (j[3] is None) == (t[3] is None)
        if j[3] is not None:
            assert bytes(j[3]) == bytes(t[3])           # label rows / scores
        assert bytes(j[4]) == bytes(t[4])               # indices
        assert bytes(j[5]) == bytes(t[5])               # values
        assert j[6] == t[6]                             # unknown labels
    assert jc.label_rows() == tc.label_rows()


@pytest.mark.parametrize("acquire", [False, True], ids=["bytearray", "pool"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_convert_raw_batch_bitwise(cfg_name, mode, acquire):
    jc, tc = both_converters(CONFIGS[cfg_name])
    frames = frames_for(mode, seed=7 + mode + len(cfg_name))
    jpool, tpool = JaxArenaPool(registry=Registry()), ArenaPool()
    if acquire:
        j = jc.convert_raw_batch(frames, mode, jpool.acquire)
        t = tc.convert_raw_batch(frames, mode, tpool.acquire)
        assert isinstance(t[3], np.ndarray) and tpool.misses == 1
    else:
        j = jc.convert_raw_batch(frames, mode)
        t = tc.convert_raw_batch(frames, mode)
        assert isinstance(t[3], bytearray)
    assert tuple(j[0]) == tuple(t[0])                   # ns
    assert j[1:3] == t[1:3]                             # b, k
    assert j[4] == t[4]                                 # unknowns
    b, k = t[1], t[2]
    nbytes = 2 * b * k * 4 + 8 * b
    assert bytes(memoryview(j[3])[:nbytes]) == bytes(memoryview(t[3])[:nbytes])


def test_convert_raw_batch_of_empty_frames():
    jc, tc = both_converters(CONFIGS["bench"])
    frames = [request([]) for _ in range(3)]
    assert jc.convert_raw_batch(frames, 0) == tc.convert_raw_batch(frames, 0) \
        == ((0, 0, 0), 0, 0, None, [])


def stream_of(n_msgs, seed):
    """Concatenated msgpack-rpc messages: train requests of various sizes,
    decoded-path requests, a notification and a response."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_msgs):
        kind = i % 4
        if kind == 0:
            rows = [[LABELS[0], wire_datum(rng)]
                    for _ in range(int(rng.integers(0, 40)))]
            parts.append(msgpack.packb([0, i, "train", ["", rows]],
                                       use_bin_type=bool(i % 3)))
        elif kind == 1:
            parts.append(msgpack.packb([0, i, "get_labels", [""]]))
        elif kind == 2:
            parts.append(msgpack.packb([2, "note", [i, "x" * int(
                rng.integers(0, 300))]]))
        else:
            parts.append(msgpack.packb([1, i, None, {"a": [1.5] * i}]))
    return b"".join(parts)


def split_all(splitter_type, stream, chunks):
    sp = splitter_type()
    out, pos = [], 0
    for n in chunks:
        sp.feed(stream[pos:pos + n])
        pos += n
        while True:
            env = sp.next()
            if env is None:
                break
            out.append(env)
    assert pos == len(stream)
    return out


@pytest.mark.parametrize("chunking", ["one_byte", "random", "whole"])
def test_frame_splitter_same_frames(chunking):
    stream = stream_of(24, seed=5)
    rng = np.random.default_rng(9)
    if chunking == "one_byte":
        chunks = [1] * len(stream)
    elif chunking == "random":
        chunks, left = [], len(stream)
        while left:
            n = min(left, int(rng.integers(1, 5000)))
            chunks.append(n)
            left -= n
    else:
        chunks = [len(stream)]
    j = split_all(jax_native.FrameSplitter, stream, chunks)
    t = split_all(native.load().FrameSplitter, stream, chunks)
    assert len(t) == 24
    assert j == t
    # the frames are the messages, with their params offsets
    pos = 0
    for msg, msgtype, msgid, method, off in t:
        assert stream[pos:pos + len(msg)] == msg
        pos += len(msg)
        assert native.load().parse_envelope(msg, 0)[1:] == \
            (msgtype, msgid, method, off)
    assert pos == len(stream)


MALFORMED = {
    "not_an_array": b"\x01",
    "array_of_2": msgpack.packb([0, 1]),
    "bad_type": msgpack.packb([7, 1, "m", []]),
    "reserved_byte": b"\x94\x00\x01\xc1",
    "string_msgid": msgpack.packb([0, "x", "m", []]),
}


@pytest.mark.parametrize("frame", sorted(MALFORMED))
def test_malformed_frames_raise_alike(frame):
    data = MALFORMED[frame]
    for mod in (jax_native, native.load()):
        sp = mod.FrameSplitter()
        sp.feed(data)
        with pytest.raises(ValueError):
            sp.next()
        with pytest.raises(ValueError):
            mod.parse_envelope(data, 0)


BAD_PARAMS = {
    "params_not_array": msgpack.packb([0, 1, "train", 5]),
    "data_not_array": msgpack.packb([0, 1, "train", ["", 42]]),
    "row_not_pair": msgpack.packb([0, 1, "train", ["", [["a"]]]]),
    "datum_too_short": msgpack.packb([0, 1, "train", ["", [["a", [[]]]]]]),
    "num_not_number": msgpack.packb(
        [0, 1, "train", ["", [["a", [[], [["x", "y"]]]]]]]),
    "truncated": msgpack.packb(
        [0, 1, "train", ["", [["a", [[["k", "v"]], []]]]]])[:-3],
}


@pytest.mark.parametrize("case", sorted(BAD_PARAMS))
def test_malformed_params_raise_alike(case):
    msg = BAD_PARAMS[case]
    off = 9                 # after fixarray(4), 0, 1 and "train"
    jc, tc = both_converters(CONFIGS["bench"])
    errors = []
    for conv in (jc, tc):
        with pytest.raises(ValueError) as e1:
            conv.convert(msg, off, 0)
        with pytest.raises(ValueError) as e2:
            conv.convert_raw_batch([(msg, off)], 0)
        errors.append((str(e1.value), str(e2.value)))
    assert errors[0] == errors[1]


def test_failed_build_raises_and_does_not_fall_back(monkeypatch):
    from jubatus_tpu_torch.models.classifier import ClassifierDriver
    monkeypatch.setenv("CC", "/bin/false")
    monkeypatch.setattr(native, "_MOD", None)
    path = native.lib_path()
    assert not path.exists()        # the compiler is part of the name
    with pytest.raises(RuntimeError, match="building the native converter "
                                           "failed"):
        native.build()
    assert not path.exists()
    with pytest.raises(RuntimeError, match="/bin/false"):
        native.load()
    with pytest.raises(RuntimeError, match="building the native converter"):
        ClassifierDriver({"converter": CONFIGS["bench"]}, device="cpu")
    monkeypatch.setenv("CC", "/no/such/compiler")
    with pytest.raises(RuntimeError, match="no/such/compiler"):
        native.build()
