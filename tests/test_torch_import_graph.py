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


def test_the_checks_cover_every_plane_of_the_port():
    """The module walk and the per-source check above include the
    durability plane, the root layout and the read lane."""
    names = {str(p.relative_to(PKG)) for p in SOURCES if PKG in p.parents}
    assert {"durability/__init__.py", "durability/fsio.py",
            "durability/journal.py", "durability/snapshotter.py",
            "durability/recovery.py", "tenancy/layout.py",
            "batching/coalescer.py"} <= names


def test_the_checks_cover_the_nearest_neighbor_slice():
    """The walk and the per-source check include the row-store modules,
    and the LSH kernels build from their own source."""
    names = {str(p.relative_to(PKG)) for p in SOURCES if PKG in p.parents}
    assert {"ops/lsh.py", "models/pages.py",
            "models/nearest_neighbor.py"} <= names
    assert "lsh" in build.KERNELS and build.flags("lsh") == build.NVCC_FLAGS


def test_the_checks_cover_the_partition_plane_and_the_proxy():
    """The walk and the per-source check include the partition plane, the
    proxy and its entry point, and importing the proxy's entry point
    pulls in neither JAX nor the JAX package."""
    names = {str(p.relative_to(PKG)) for p in SOURCES if PKG in p.parents}
    assert {"framework/partition.py", "framework/proxy.py",
            "cli/proxy.py"} <= names
    r = _run("import sys, jubatus_tpu_torch.cli.proxy\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r})\n"
             "print(bad)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_the_checks_cover_the_operating_plane():
    """The walk and the per-source check include the tracer, the
    exporter, the logger, the signal actions, the query cache and the
    lock-order detector, and importing them pulls in neither JAX nor the
    JAX package."""
    names = {str(p.relative_to(PKG)) for p in SOURCES if PKG in p.parents}
    mods = {"obs/__init__.py", "obs/trace.py", "obs/exporter.py",
            "utils/logger.py", "utils/signals.py", "utils/metrics.py",
            "framework/query_cache.py", "analysis/__init__.py",
            "analysis/lockgraph.py"}
    assert mods <= names
    dotted = ", ".join("jubatus_tpu_torch." + m[:-3].replace("/", ".")
                       .replace(".__init__", "") for m in sorted(mods))
    r = _run(f"import sys, {dotted}\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r})\n"
             "print(bad)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_the_checks_cover_the_tenancy_plane_and_the_plugins():
    """The walk and the per-source check include the slot registry, the
    quotas, the layout, the plugin loader and its shipped plugins, and
    importing them pulls in neither JAX nor the JAX package."""
    names = {str(p.relative_to(PKG)) for p in SOURCES if PKG in p.parents}
    mods = {"tenancy/__init__.py", "tenancy/registry.py",
            "tenancy/quotas.py", "tenancy/layout.py", "fv/plugin.py",
            "native/plugins/__init__.py"}
    assert mods | {"fv/plugins/dict_splitter.py"} <= names
    assert {"simple_splitter.c", "trie_splitter.c"} <= {
        p.name for p in (PKG / "native" / "plugins").glob("*.c")}
    dotted = ", ".join("jubatus_tpu_torch." + m[:-3].replace("/", ".")
                       .replace(".__init__", "") for m in sorted(mods))
    r = _run(f"import sys, {dotted}\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r})\n"
             "print(bad)\n")
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
    from jubatus_tpu_torch.models.regression import RegressionDriver
    from tests.test_torch_regression import config as reg_config
    with pytest.raises(RuntimeError, match="is_available"):
        RegressionDriver(reg_config())


def test_nearest_neighbor_without_a_card_raises(monkeypatch, tmp_path):
    """The NN driver defaults to cuda and raises without it; so does the
    server CLI for --type nearest_neighbor without --device cpu."""
    from jubatus_tpu_torch.models.nearest_neighbor import \
        NearestNeighborDriver
    from tests.test_torch_nearest_neighbor import config as nn_config
    from tests.test_torch_server import _cli
    proc = _cli(tmp_path, None, nn_config("minhash"), "nearest_neighbor",
                CUDA_VISIBLE_DEVICES="")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        NearestNeighborDriver(nn_config("lsh"))
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "jubatus ready" not in out and "is_available" in err


def test_cpu_and_unsupported_devices():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")
    tdevice.device_sync(torch.device("cpu"))
    # the allocator gauges (utils/metrics.py): no HBM keys without a card
    from jubatus_tpu_torch.utils.metrics import device_telemetry
    if not torch.cuda.is_available():
        assert device_telemetry() == {"device_count": 0.0}


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


def test_only_the_scans_flush_subnormals_and_flags_enter_the_hash(
        monkeypatch):
    """-ftz=true (XLA's flush of float32 subnormals) goes to the two scan
    kernels and not to the quantizer, whose wire bytes must equal the
    host codec's; a kernel's flags are part of its library's name."""
    assert build.flags("quantize") == build.NVCC_FLAGS
    for name in ("train_scan", "regression_scan"):
        assert build.flags(name) == build.NVCC_FLAGS + ("-ftz=true",)
    assert set(build.KERNEL_FLAGS) <= set(build.KERNELS)
    before = {n: build.lib_path(n) for n in build.KERNELS}
    monkeypatch.setitem(build.KERNEL_FLAGS, "regression_scan", ())
    assert build.lib_path("regression_scan") != before["regression_scan"]
    assert build.lib_path("train_scan") == before["train_scan"]
    assert build.lib_path("quantize") == before["quantize"]


def test_a_variant_library_follows_its_source_and_flags(monkeypatch,
                                                       tmp_path):
    """load_variant (an earlier checkout's kernel, for an A/B) names its
    library by kernel, label, source and flags, builds it once and
    reuses it; nvcc and the loader are stood in for here."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", None)

    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    src = tmp_path / "regression_scan.cu"
    src.write_text("// one version\n")
    a = build.load_variant("regression_scan", src, "earlier")
    assert a == build.load_variant("regression_scan", src, "earlier")
    assert len(runs) == 1 and runs[0][1:-3] == list(
        build.flags("regression_scan"))
    assert a.startswith(str(tmp_path / "out" / "libregression_scan_earlier-"))
    b = build.load_variant("regression_scan", src, "earlier",
                           build.NVCC_FLAGS)
    src.write_text("// another version\n")
    c = build.load_variant("regression_scan", src, "earlier")
    assert len({a, b, c}) == 3 and len(runs) == 3


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
