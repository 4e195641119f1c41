"""The port's C feature-extraction plugins and their build.

Two C sources, copies of the JAX package's (jubatus_tpu/native/plugins/):

  simple_splitter.c  a whitespace tokenizer: `create(text, begins,
                     lengths, max)`
  trie_splitter.c    a dictionary trie: `split` (every dictionary word at
                     every position, the ux_splitter role) and
                     `viterbi_split` (a min-cost segmentation with word
                     costs and an optional connection matrix, the
                     mecab_splitter role), each with its `<fn>_init(dict)`

A converter config names one with `"method": "dynamic"` and a `path`:
a built `.so`, or a `.c` source, which fv/plugin.py builds here at first
use:

    cc -shared -fPIC -O2 <source> -o build/torch_plugins/<stem>-<hash>.so

The file name carries a hash of the source, the compiler and the flags,
so an edited source rebuilds and an unchanged one is reused; the build
writes a temporary name and renames it under a lock file, so processes
racing the first build all load a whole library.  $CC names the compiler
(default cc).  A failed build raises with the compiler's output.  The
plugins run on the host, in the converter, before any tensor exists.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Union

PLUGIN_DIR = Path(__file__).resolve().parent
SOURCES = ("simple_splitter.c", "trie_splitter.c")
BUILD_DIR = PLUGIN_DIR.parents[2] / "build" / "torch_plugins"
CFLAGS = ("-shared", "-fPIC", "-O2")


def source(name: str) -> Path:
    """The path of a shipped plugin source by its file name."""
    if name not in SOURCES:
        raise ValueError(f"no shipped C plugin {name!r} (have {SOURCES})")
    return PLUGIN_DIR / name


def _command(src: Path, out: Path) -> List[str]:
    return [os.environ.get("CC", "cc"), *CFLAGS, str(src), "-o", str(out)]


def lib_path(src: Union[str, Path]) -> Path:
    """Where the library of `src` for its current bytes and command
    lives."""
    src = Path(src).resolve()
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_command(Path("src.c"), Path("out"))).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: Union[str, Path]) -> Path:
    """Compile the C plugin `src` unless its library exists; returns the
    library's path.  Raises RuntimeError with the compiler's output when
    the build fails."""
    src = Path(src).resolve()
    out = lib_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build_lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                  # another process built it
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = _command(src, tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building the C plugin {src.name} failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the C plugin {src.name} failed (exit "
                f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, out)
    return out
