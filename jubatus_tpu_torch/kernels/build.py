"""Build and load the port's CUDA kernels.

Each source in jubatus_tpu_torch/csrc/ is compiled by nvcc on its own into
a shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/torch_kernels/lib<name>-<hash>.so \
         jubatus_tpu_torch/csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Kernels build at first
use, from the checkout's sources only; build_all() starts one nvcc per
source, all at once.  No --use_fast_math: the quantizer's bitwise parity
with numpy needs IEEE division.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

KERNELS = ("quantize", "train_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels cannot build")
    return found


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last
    build of `name`, or "" when it was reused from an earlier build."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc
    process per source, all started together.  Returns seconds per kernel
    (0.0 when reused).  Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    times: Dict[str, float] = {}
    t0 = time.monotonic()
    for name in names:
        out = lib_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        times[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
