"""The port's dynamic plugin loader (jubatus_tpu_torch/fv/plugin.py)
against the JAX package's (tests/test_plugin.py's cases, side by side).

  * the Python plugins: fv/plugins/dict_splitter.py's spans, a string
    filter, a num_feature, a binary_feature and a num_filter plugin give
    the JAX loader's objects' answers, and a `"method": "dynamic"`
    converter config gives the JAX converter's feature vectors;
  * the C plugins (native/plugins/simple_splitter.c and trie_splitter.c,
    compiled with cc by native/plugins/): the spans of both splitters,
    the trie's ux and viterbi modes, UTF-8 text, word costs, a connection
    matrix, two dictionaries in one library, the token cap, a missing
    dictionary and a malformed matrix, each as the JAX loader gives them
    on the same library; a config naming the `.c` source builds it at
    first use; a source that does not compile raises.  They skip where
    no C compiler is found, as tests/test_plugin.py does;
  * a classifier driver whose config takes a dynamic C splitter trains on
    the decoded route and ends in the JAX driver's tables, within
    tests/test_torch_classifier.py's tolerance.
"""

import os
import shutil
import textwrap

import numpy as np
import pytest

from jubatus_tpu.fv import ConverterConfig as JConfig
from jubatus_tpu.fv import Datum as JDatum
from jubatus_tpu.fv import DatumToFVConverter as JConverter
from jubatus_tpu.fv.plugin import PluginError as JPluginError
from jubatus_tpu.fv.plugin import load_object as jload
from jubatus_tpu.models import create_driver as jcreate
from jubatus_tpu_torch.fv import ConverterConfig as TConfig
from jubatus_tpu_torch.fv import Datum as TDatum
from jubatus_tpu_torch.fv import DatumToFVConverter as TConverter
from jubatus_tpu_torch.fv.plugin import PluginError as TPluginError
from jubatus_tpu_torch.fv.plugin import load_object as tload
from jubatus_tpu_torch.models import create_driver as tcreate
from jubatus_tpu_torch.native import plugins
from tests.test_torch_classifier import ATOL, RTOL
from tests.test_torch_durability import tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICT_SPLITTER = os.path.join(REPO, "jubatus_tpu_torch", "fv", "plugins",
                             "dict_splitter.py")
TRIE_DICT = os.path.join(REPO, "tests", "fixtures", "trie_dict.txt")
NO_CC = shutil.which(os.environ.get("CC", "cc")) is None
needs_cc = pytest.mark.skipif(NO_CC, reason="no C compiler")


def features(converter_json, datum_fn):
    """The feature lists of both packages' converters for one datum."""
    out = []
    for cfg, conv, dat in ((JConfig, JConverter, JDatum),
                           (TConfig, TConverter, TDatum)):
        c = conv(cfg.from_json(dict(converter_json)))
        out.append(sorted(c.extract(datum_fn(dat()))))
    return out


def write_plugin(tmp_path, body, name="plug.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


# ---------------------------------------------------------------------------
# Python plugins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params,text", [
    ({"words": ["ab", "abc", "de"]}, "abcxdeab"),
    ({"words": ["spam", "ham"]}, "spam and spam and ham"),
    ({"words": ["あい", "い", "tokyo"]}, "あいtokyoい"),
    ({"words": []}, "anything"),
])
def test_dict_splitter_spans_match_jax(params, text):
    jax_path = DICT_SPLITTER.replace("jubatus_tpu_torch", "jubatus_tpu")
    assert tload(DICT_SPLITTER, "create", params).split(text) == \
        jload(jax_path, "create", params).split(text)


def test_dict_splitter_reads_a_dictionary_file(tmp_path):
    d = tmp_path / "words.txt"
    d.write_text("alpha\nbeta\n")
    obj = tload(DICT_SPLITTER, "create", {"dict_path": str(d)})
    assert obj.split("alphabeta") == [(0, 5), (5, 4)]


@pytest.mark.parametrize("sample_weight", ["bin", "tf", "log_tf"])
def test_a_dynamic_python_splitter_gives_jax_features(sample_weight):
    cfg = {"string_types": {
               "dict": {"method": "dynamic", "path": DICT_SPLITTER,
                        "function": "create", "words": ["spam", "ham"]}},
           "string_rules": [{"key": "*", "type": "dict",
                             "sample_weight": sample_weight,
                             "global_weight": "bin"}],
           "hash_max_size": 512}
    j, t = features(cfg, lambda d: d.add_string("t", "spam and spam ham"))
    assert t == j and len(t) == 2


def test_python_filter_num_and_binary_plugins_give_jax_features(tmp_path):
    path = write_plugin(tmp_path, """
        class Lower:
            def filter(self, text):
                return text.lower()
        class Sq:
            def extract(self, key, value):
                return [(key + "@sq", value * value)]
        class Clip:
            def filter(self, value):
                return min(value, 2.0)
        class Len:
            def extract(self, key, value):
                return [(key + "@len", float(len(value)))]
        def lower(params):
            return Lower()
        def sq(params):
            return Sq()
        def clip(params):
            return Clip()
        def blen(params):
            return Len()
    """)
    cfg = {"string_filter_types": {"lower": {"method": "dynamic",
                                             "path": path,
                                             "function": "lower"}},
           "string_filter_rules": [{"key": "*", "type": "lower",
                                    "suffix": "_lc"}],
           "string_rules": [{"key": "*_lc", "type": "str",
                             "sample_weight": "bin",
                             "global_weight": "bin"}],
           "num_filter_types": {"clip": {"method": "dynamic", "path": path,
                                         "function": "clip"}},
           "num_filter_rules": [{"key": "x", "type": "clip",
                                 "suffix": "_c"}],
           "num_types": {"sq": {"method": "dynamic", "path": path,
                                "function": "sq"}},
           "num_rules": [{"key": "*", "type": "sq"}],
           "binary_types": {"len": {"method": "dynamic", "path": path,
                                    "function": "blen"}},
           "binary_rules": [{"key": "*", "type": "len"}],
           "hash_max_size": 512}
    j, t = features(cfg, lambda d: d.add_string("t", "HeLLo")
                    .add_number("x", 3.0).add_binary("b", b"\x00\x01\x02"))
    assert t == j
    keys = {k for k, _, _ in t}
    assert {"x@sq", "x_c@sq", "b@len"} <= keys
    assert any("hello" in k for k in keys)


def test_a_missing_symbol_raises_and_instances_are_cached(tmp_path):
    path = write_plugin(tmp_path, """
        calls = []
        def create(params):
            calls.append(1)
            return object()
    """)
    with pytest.raises(TPluginError, match="no symbol"):
        tload(path, "nothing", {})
    a = tload(path, "create", {"p": 1})
    assert tload(path, "create", {"p": 1}) is a
    assert tload(path, "create", {"p": 2}) is not a


# ---------------------------------------------------------------------------
# C plugins
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def libs():
    if NO_CC:
        pytest.skip("no C compiler")
    return {name: str(plugins.build(plugins.source(name)))
            for name in plugins.SOURCES}


def both(lib, function, params, text):
    """The spans of the port's and the JAX loader's object on `text`."""
    return (tload(lib, function, params).split(text),
            jload(lib, function, params).split(text))


@needs_cc
@pytest.mark.parametrize("text", ["hello  world", "a b a", "", "  ",
                                  "tab\tnew\nline", "ütf-8 wörds ok"])
def test_simple_splitter_spans_match_jax(libs, text):
    t, j = both(libs["simple_splitter.c"], "create", {}, text)
    assert t == j


@needs_cc
@pytest.mark.parametrize("function,text,want", [
    ("split", "tokyoto", [(0, 2), (0, 5), (2, 5), (5, 2)]),
    ("viterbi_split", "tokyokyoto", [(0, 5), (5, 5)]),
    ("viterbi_split", "xxztokyo", [(0, 3), (3, 5)]),
    ("viterbi_split", "あいtokyo", [(0, 2), (2, 5)]),
    ("split", "spamhamspam", None),
    ("viterbi_split", "spamhamspam", None),
])
def test_trie_splitter_modes_match_jax(libs, function, text, want):
    t, j = both(libs["trie_splitter.c"], function,
                {"dict_path": TRIE_DICT}, text)
    assert t == j
    if want is not None:
        assert t == want


@needs_cc
def test_trie_dictionaries_costs_and_matrix_match_jax(libs, tmp_path):
    lib = libs["trie_splitter.c"]
    other = tmp_path / "animals.txt"
    other.write_text("cat\ndog\n")
    for d in (TRIE_DICT, str(other)):
        t, j = both(lib, "split", {"dict_path": d}, "catdogtokyo")
        assert t == j
    assert tload(lib, "split", {"dict_path": TRIE_DICT}) is not \
        tload(lib, "split", {"dict_path": str(other)})
    costs = tmp_path / "costs.txt"
    costs.write_text("ab\t1000\nabab\t9000\n")
    t, j = both(lib, "viterbi_split", {"dict_path": str(costs)}, "abab")
    assert t == j == [(0, 2), (2, 2)]
    withids = tmp_path / "conn.txt"
    withids.write_text(
        "ab\t100\t1\t1\nc\t100\t1\t1\na\t150\t2\t2\nbc\t150\t2\t2\n")
    (tmp_path / "conn.txt.matrix").write_text("3 3\n1 1 10000\n")
    t, j = both(lib, "viterbi_split", {"dict_path": str(withids)}, "abc")
    assert t == j == [(0, 1), (1, 2)]


@needs_cc
def test_trie_token_cap_and_long_text_match_jax(libs):
    lib = libs["trie_splitter.c"]
    for text in ("z" * 20000, "ham!" * 4000):
        t, j = both(lib, "viterbi_split", {"dict_path": TRIE_DICT}, text)
        assert t == j
    assert len(t) == 4096 and t[:2] == [(0, 3), (3, 1)]


@needs_cc
def test_trie_refusals_match_jax(libs, tmp_path):
    lib = libs["trie_splitter.c"]
    with pytest.raises(TPluginError):
        tload(lib, "split", {"dict_path": "/nonexistent/d.txt"})
    with pytest.raises(JPluginError):
        jload(lib, "split", {"dict_path": "/nonexistent/d.txt"})
    bad = tmp_path / "bad.txt"
    bad.write_text("ab\t100\t1\t1\n")
    (tmp_path / "bad.txt.matrix").write_text("3 3\n1 1 10x00\n")
    with pytest.raises(TPluginError):
        tload(lib, "viterbi_split", {"dict_path": str(bad)})


@needs_cc
@pytest.mark.parametrize("source,function,params,text", [
    ("simple_splitter.c", "create", {}, "a b a c"),
    ("trie_splitter.c", "viterbi_split", {"dict_path": TRIE_DICT},
     "spamhamspam"),
])
def test_a_dynamic_c_config_gives_jax_features(libs, source, function,
                                               params, text):
    """The port's config names the .c source (built at first use); the
    JAX converter reads the library built from it."""
    def cfg(path):
        return {"string_types": {"p": dict(params, method="dynamic",
                                           path=path, function=function)},
                "string_rules": [{"key": "*", "type": "p",
                                  "sample_weight": "tf",
                                  "global_weight": "bin"}],
                "hash_max_size": 512}
    jconv = JConverter(JConfig.from_json(cfg(libs[source])))
    tconv = TConverter(TConfig.from_json(cfg(str(plugins.source(source)))))
    want = sorted(jconv.extract(JDatum().add_string("t", text)))
    got = sorted(tconv.extract(TDatum().add_string("t", text)))
    assert got == want and any(v == 2.0 for _, v, _ in got)


@needs_cc
def test_a_c_plugin_that_does_not_build_raises(tmp_path):
    src = tmp_path / "broken.c"
    src.write_text("int create(const char* t) { return }\n")
    with pytest.raises(RuntimeError, match="building the C plugin"):
        plugins.build(src)
    with pytest.raises(RuntimeError, match="building the C plugin"):
        tload(str(src), "create", {})


@needs_cc
def test_a_classifier_with_a_dynamic_c_splitter_trains_as_jax(libs):
    conv = {"string_types": {"ws": {"method": "dynamic",
                                    "path": libs["simple_splitter.c"],
                                    "function": "create"}},
            "string_rules": [{"key": "*", "type": "ws",
                              "sample_weight": "tf",
                              "global_weight": "bin"}],
            "hash_max_size": 1 << 12}
    cfg = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
           "converter": conv}
    tdrv = tcreate("classifier", cfg, device="cpu")
    jdrv = jcreate("classifier", cfg)
    assert getattr(tdrv, "_fast", None) is None     # the decoded route
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(40)]
    for _ in range(6):
        rows = [(f"l{int(rng.integers(3))}",
                 " ".join(rng.choice(words, int(rng.integers(2, 7)))))
                for _ in range(8)]
        tdrv.train([(lbl, TDatum().add_string("t", s)) for lbl, s in rows])
        jdrv.train([(lbl, JDatum().add_string("t", s)) for lbl, s in rows])
    want, got = tables("classifier", jdrv.pack()), \
        tables("classifier", tdrv.pack())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
