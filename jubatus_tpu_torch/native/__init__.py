"""The port's native host layer: the C wire converter and stream framer.

Two C sources, copies of the JAX package's (the arena layout, bucketing,
label interning and FNV-1a64 are the same byte for byte):

  _fastconv.c        FastConverter (wire train/classify payloads -> padded
                     [B, K] buffers; N train frames -> one packed
                     [idx | val | aux | mask] arena in one GIL-released
                     call), FrameSplitter (resumable msgpack-RPC stream
                     framing) and parse_envelope
  _jubatus_native.c  the module init that registers them, with fnv1a64,
                     crc32, hash_keys and pack_rows

Both compile together into one extension at first use, never at import:

    cc -shared -fPIC -O3 -I<python include> _jubatus_native.c _fastconv.c \
       -o build/torch_native/_jubatus_native-<hash>.so

The file name carries a hash of the sources, the compiler and the flags,
so an edited source rebuilds and an unchanged one is reused.  The build
writes a temporary name and renames it under a lock file, so processes
racing the first build all load a whole library.  $CC names the compiler
(default cc).  A failed build raises with the compiler's output: the
port's raw train path has no Python stand-in for it.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent
SOURCES = ("_jubatus_native.c", "_fastconv.c")
BUILD_DIR = PKG_DIR.parents[1] / "build" / "torch_native"
CFLAGS = ("-shared", "-fPIC", "-O3")
MODULE = "jubatus_tpu_torch.native._jubatus_native"

_MOD: Optional[ModuleType] = None
_LOCK = threading.Lock()


def _command(out: Path) -> List[str]:
    return [os.environ.get("CC", "cc"), *CFLAGS,
            "-I", sysconfig.get_paths()["include"],
            *(str(PKG_DIR / s) for s in SOURCES), "-o", str(out)]


def lib_path() -> Path:
    """Where the extension for the current sources and command lives."""
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((PKG_DIR / s).read_bytes())
    h.update(" ".join(_command(Path("out"))).encode())
    return BUILD_DIR / f"_jubatus_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the extension unless it exists; returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build_lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                  # another process built it
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = _command(tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building the native converter failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native converter failed (exit "
                f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ModuleType:
    """The loaded extension module, built first if needed."""
    global _MOD
    with _LOCK:
        if _MOD is None:
            path = str(build())
            loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
            spec = importlib.util.spec_from_file_location(MODULE, path,
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _MOD = mod
        return _MOD
