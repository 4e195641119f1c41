"""Build and load the port's CUDA kernels.

Each source in jubatus_tpu_torch/csrc/ is compiled by nvcc on its own into
a shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/torch_kernels/lib<name>-<hash>.so \
         jubatus_tpu_torch/csrc/<name>.cu

plus the kernel's own flags (KERNEL_FLAGS).  The library name carries a
hash of the source and of all its flags, so an edited source or flag
rebuilds and an unchanged one is reused.  Kernels build at first use,
from the checkout's sources only; build_all() starts one nvcc per source,
all at once.  No --use_fast_math: the quantizer's bitwise parity with
numpy needs IEEE division.  The two scans are built with -ftz=true:
float32 subnormal inputs read as zero and subnormal results flush to
zero, as XLA computes the scans they replace; the quantizer keeps the
default, so its wire bytes stay equal to the host codec's, and so do the
LSH kernels, which round as their plain PyTorch versions do.  Nothing here
runs at import time.  A kernel that cannot be built, loaded or launched
raises KernelError (a RuntimeError), so a caller that must not carry on
without its kernels (boot recovery) can tell it from a bad input.
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
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

KERNELS = ("quantize", "train_scan", "regression_scan", "lsh",
           "candidates")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# flags of one kernel beyond NVCC_FLAGS
KERNEL_FLAGS = {"train_scan": ("-ftz=true",),
                "regression_scan": ("-ftz=true",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on "
                          "PATH); the port's CUDA kernels cannot build")
    return found


def flags(name: str) -> tuple:
    """nvcc's flags for kernel `name`: NVCC_FLAGS, then its own."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _hashed_path(stem: str, src: bytes, nvcc_flags: Iterable[str]) -> Path:
    digest = hashlib.sha256(src + " ".join(nvcc_flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{digest[:16]}.so"


def lib_path(name: str) -> Path:
    return _hashed_path(name, (SRC_DIR / f"{name}.cu").read_bytes(),
                        flags(name))


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
        cmd = [nvcc, *flags(name), "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
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
        raise KernelError("\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            try:
                lib = ctypes.CDLL(str(lib_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load the {name} kernel: {e}") \
                    from e
            _LIBS[name] = lib
        return lib


def load_variant(name: str, src, label: str,
                 nvcc_flags: Optional[Iterable[str]] = None) -> ctypes.CDLL:
    """Kernel `name` built from the source file `src` (another checkout's,
    for an A/B against the current kernel) with `nvcc_flags` (by default
    flags(name)) into lib<name>_<label>-<hash>.so beside the kernels' own
    libraries, the hash taken over the source and the flags as in
    lib_path; reused while both are unchanged."""
    fl = tuple(flags(name) if nvcc_flags is None else nvcc_flags)
    out = _hashed_path(f"{name}_{label}", Path(src).read_bytes(), fl)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([nvcc_path(), *fl, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")
