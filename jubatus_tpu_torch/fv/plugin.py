"""Dynamic feature-extraction plugins (the port's copy of
jubatus_tpu/fv/plugin.py, the reference's so_factory / dynamic_loader
role).

A converter config selects one with `"method": "dynamic", "path":
<file>, "function": <factory>` (default `create`); the type-def's other
keys are the plugin's params.  Two flavours, one config surface:

  * Python plugin: `path` is a .py file (or a dotted module name).  The
    factory is called with the type-def and returns an object with the
    kind's interface:
      - string_feature: `split(text) -> [(begin, length)]` (the
        word_splitter convention) or `tokens(text) -> [(token, count)]`
      - string_filter:  `filter(text) -> str`
      - num_feature:    `extract(key, value) -> [(feature_key, value)]`
      - binary_feature: `extract(key, bytes) -> [(feature_key, value)]`
      - num_filter:     `filter(value) -> float`
  * C shared object, string_feature only: `path` is a .so, or a .c
    source that native/plugins/ builds with cc at first use (a failed
    build raises).  The library exports `int <function>(const char*
    text, int* begins, int* lengths, int max_tokens)` returning the
    token count (byte offsets and lengths); a stateful splitter also
    exports `int <function>_init(const char* dict_path)` returning a
    handle, which `<function>` then takes first, so one library serves
    any number of dictionaries.  The shipped C splitters are
    native/plugins/simple_splitter.c and trie_splitter.c;
    fv/plugins/dict_splitter.py is the shipped Python one.

Modules and libraries load once a path, and instances once a (path,
function, params); the converter finds a type-def's instance on the
type-def itself after the first call.  Importing this module installs
the `dynamic` method into fv/converter.py's registries.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import os
import threading
from typing import Any, Dict, List, Tuple

_cache: Dict[Tuple[str, str], Any] = {}
_modules: Dict[str, Any] = {}
_lock = threading.Lock()

# where a type-def keeps its resolved instance (a name of the port's own,
# so a type-def dict a JAX converter also reads keeps the two apart)
_OBJ_KEY = "__jubatus_torch_plugin_instance__"


class PluginError(RuntimeError):
    pass


def _load_python_module(path: str):
    if path.endswith(".py") or os.path.sep in path:
        name = ("jubatus_tpu_torch_plugin_"
                + os.path.basename(path).replace(".py", ""))
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise PluginError(f"cannot load plugin module: {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(path)


def _params_key(params: Dict[str, Any]) -> str:
    return json.dumps({k: v for k, v in params.items()
                       if k != "method" and not k.startswith("__jubatus")},
                      sort_keys=True, default=str)


def _resolve(tdef: Dict[str, Any]):
    """The type-def's instance: loaded at the first call, then one dict
    read (no lock, no params serialization a value)."""
    obj = tdef.get(_OBJ_KEY)
    if obj is None:
        obj = load_object(tdef["path"], tdef.get("function", "create"), tdef)
        tdef[_OBJ_KEY] = obj
    return obj


def load_object(path: str, function: str, params: Dict[str, Any]):
    """The plugin instance (dlopen + create): the module or library is
    loaded once a path, the factory's instance once a (path, function,
    params), so two type-defs with other params get distinct objects.  A
    `.c` path is built first (native/plugins/)."""
    norm = os.path.abspath(path) if os.path.sep in path else path
    key = (norm, function + "|" + _params_key(params))
    with _lock:
        obj = _cache.get(key)
        if obj is not None:
            return obj
        if path.endswith(".c"):
            from jubatus_tpu_torch.native import plugins
            obj = _CSplitter(str(plugins.build(path)), function, params)
        elif path.endswith(".so"):
            obj = _CSplitter(path, function, params)
        else:
            mod = _modules.get(norm)
            if mod is None:
                mod = _load_python_module(path)
                _modules[norm] = mod
            factory = getattr(mod, function, None)
            if factory is None:
                raise PluginError(f"plugin {path} has no symbol {function!r}")
            obj = factory(params)
        _cache[key] = obj
        return obj


class _CSplitter:
    """ctypes wrapper over the C splitter convention."""

    MAX_TOKENS = 4096

    def __init__(self, path: str, function: str, params: Dict[str, Any] = None):
        self.lib = ctypes.CDLL(path)
        try:
            self.fn = getattr(self.lib, function)
        except AttributeError as e:
            raise PluginError(f"{path} exports no symbol {function!r}") from e
        self.fn.restype = ctypes.c_int
        init = getattr(self.lib, function + "_init", None)
        self.handle: "int | None" = None
        if init is not None:
            # stateful convention: init(dict_path) -> handle, then
            # split(handle, ...)
            init.restype = ctypes.c_int
            init.argtypes = [ctypes.c_char_p]
            dict_path = str((params or {}).get("dict_path", ""))
            h = init(dict_path.encode("utf-8", "surrogateescape"))
            if h < 0:
                raise PluginError(
                    f"{path}:{function}_init({dict_path!r}) failed ({h})")
            self.handle = h
            self.fn.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.c_int]
        else:
            self.fn.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.c_int]

    def split(self, text: str) -> List[Tuple[int, int]]:
        raw = text.encode("utf-8", "surrogateescape")
        begins = (ctypes.c_int * self.MAX_TOKENS)()
        lengths = (ctypes.c_int * self.MAX_TOKENS)()
        if self.handle is not None:
            n = self.fn(self.handle, raw, begins, lengths, self.MAX_TOKENS)
        else:
            n = self.fn(raw, begins, lengths, self.MAX_TOKENS)
        if n < 0:
            raise PluginError(f"C splitter returned {n}")
        # offsets are over the UTF-8 bytes; spans arrive in ascending
        # order, so one forward walk maps byte -> char positions in O(n)
        out = []
        byte_pos = 0
        char_pos = 0
        for i in range(min(n, self.MAX_TOKENS)):
            b, ln = begins[i], lengths[i]
            if b < byte_pos:  # an out-of-order plugin: rescan
                byte_pos, char_pos = 0, 0
            char_pos += len(raw[byte_pos:b].decode(errors="ignore"))
            byte_pos = b
            out.append((char_pos, len(raw[b:b + ln].decode(errors="ignore"))))
        return out


def _tokens_from(obj, text: str) -> List[Tuple[str, int]]:
    """Either splitter convention as [(token, count)]."""
    if hasattr(obj, "tokens"):
        return list(obj.tokens(text))
    if hasattr(obj, "split"):
        counts: Dict[str, int] = {}
        for begin, length in obj.split(text):
            tok = text[begin : begin + length]
            if tok:
                counts[tok] = counts.get(tok, 0) + 1
        return list(counts.items())
    raise PluginError(f"string_feature plugin {obj!r} has no split/tokens")


# -- adapters to the converter's registry signatures ------------------------

def dynamic_string_feature(tdef: Dict, value: str) -> List[Tuple[str, int]]:
    return _tokens_from(_resolve(tdef), value)


def dynamic_string_filter(tdef: Dict, value: str) -> str:
    return _resolve(tdef).filter(value)


def dynamic_num_feature(tdef: Dict, key: str, value: float) -> List[Tuple[str, float]]:
    return list(_resolve(tdef).extract(key, value))


def dynamic_num_filter(tdef: Dict, value: float) -> float:
    return float(_resolve(tdef).filter(value))


def dynamic_binary_feature(tdef: Dict, key: str, value: bytes) -> List[Tuple[str, float]]:
    return list(_resolve(tdef).extract(key, value))


def register_dynamic() -> None:
    """Install the `dynamic` method into the converter's registries."""
    from jubatus_tpu_torch.fv import converter as c
    c.STRING_FEATURE_PLUGINS.setdefault("dynamic", dynamic_string_feature)
    c.STRING_FILTER_PLUGINS.setdefault("dynamic", dynamic_string_filter)
    c.NUM_FEATURE_PLUGINS.setdefault("dynamic", dynamic_num_feature)
    c.NUM_FILTER_PLUGINS.setdefault("dynamic", dynamic_num_filter)
    c.BINARY_FEATURE_PLUGINS.setdefault("dynamic", dynamic_binary_feature)


register_dynamic()
