"""The port stands alone: jubatus_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, entry points refuse a device that is not
there, and chip_smoke.py fails without a card or without the repo."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jubatus_tpu_torch
from jubatus_tpu_torch import device as tdevice
from jubatus_tpu_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jubatus_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "jubatus_tpu")
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), **env})


def test_server_import_pulls_in_no_jax():
    r = _run("import sys, jubatus_tpu_torch.cli.server\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r})\n"
             "print(bad)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_every_module_imports_without_jax():
    r = _run("import sys, pkgutil, importlib, jubatus_tpu_torch as p\n"
             "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
             "    importlib.import_module(m.name)\n"
             "import chip_smoke\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r}))\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


# -- devices --------------------------------------------------------------------

def test_cuda_without_a_card_raises(monkeypatch):
    from jubatus_tpu_torch.models.classifier import ClassifierDriver
    from tests.test_torch_classifier import config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            tdevice.resolve_device(dev)
    with pytest.raises(RuntimeError):
        ClassifierDriver(config())          # the default device is cuda


def test_cpu_and_unsupported_devices():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")
    tdevice.device_sync(torch.device("cpu"))
    assert tdevice.device_telemetry(torch.device("cpu")) == {}


# -- kernel build rule ------------------------------------------------------------

def test_build_rule_targets_hopper_without_fast_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-O3" in flags and "-shared" in flags and "-fPIC" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert set(build.KERNELS) == {p.stem for p in build.SRC_DIR.glob("*.cu")}


def test_library_name_follows_the_source():
    a, b = build.lib_path("quantize"), build.lib_path("train_scan")
    assert a != b and a.parent == b.parent == build.BUILD_DIR
    assert build.lib_path("quantize") == a              # deterministic


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_check_raises_on_a_cuda_error():
    build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check(9, "launch")


def test_version_matches_the_jax_package():
    import jubatus_tpu
    assert jubatus_tpu_torch.__version__ == jubatus_tpu.__version__


# -- chip_smoke.py refuses to run where it cannot ---------------------------------

def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_without_a_card_fails():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "is_available() is False" in r.stderr
