"""Package + optional native extension.

    pip install -e .                      # package + juba* entry points
    python setup.py build_ext --inplace   # just the C extension

Everything in jubatus_tpu falls back to pure Python when the extension
is absent; building it accelerates the host-side serving hot paths
(feature hashing, model checksums, microbatch packing).  The juba*
console scripts mirror the reference's installed binaries
(/root/reference/jubatus/server/cmd + per-engine juba* servers —
here one server binary takes --type).
"""

import os
import re

from setuptools import Extension, find_packages, setup


def _version() -> str:
    """Single source of truth: jubatus_tpu/__init__.py __version__
    (tracks the reference wire/model version; deploy/ artifacts read the
    same line)."""
    init = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "jubatus_tpu", "__init__.py")
    with open(init) as f:
        return re.search(r'^__version__ = "([^"]+)"', f.read(),
                         re.MULTILINE).group(1)


setup(
    name="jubatus_tpu",
    version=_version(),
    packages=find_packages(include=["jubatus_tpu", "jubatus_tpu.*",
                                    "jubatus_tpu_torch", "jubatus_tpu_torch.*"]),
    package_data={
        # C sources ship with the package: plugins compile on demand
        # (like the reference's plugin/ tree), and the extension can
        # rebuild in-place for developers; a sourceless install simply
        # uses the compiled extension the wheel carries
        "jubatus_tpu.native": ["*.c", "plugins/*.c"],
        "jubatus_tpu.fv": ["plugins/*.py"],
        # the jubalint baseline ships with the linter so CI runs see
        # the same accepted-violation set as the checkout
        "jubatus_tpu.analysis": ["baseline.txt"],
        # the PyTorch port's CUDA kernels build with nvcc at first use
        "jubatus_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "msgpack", "numpy"],
    entry_points={
        "console_scripts": [
            "jubatus-server = jubatus_tpu.cli.server:main",
            "jubatus-proxy = jubatus_tpu.cli.proxy:main",
            "jubacoordinator = jubatus_tpu.cluster.coordinator:main",
            "jubavisor = jubatus_tpu.cluster.jubavisor:main",
            "jubactl = jubatus_tpu.cli.jubactl:main",
            "jubaconfig = jubatus_tpu.cli.jubaconfig:main",
            "jubaconv = jubatus_tpu.cli.jubaconv:main",
            "jubadoc = jubatus_tpu.cli.jubadoc:main",
            "jubagen = jubatus_tpu.cli.jubagen:main",
        ],
    },
    ext_modules=[
        Extension(
            "jubatus_tpu.native._jubatus_native",
            sources=["jubatus_tpu/native/_jubatus_native.c",
                     "jubatus_tpu/native/_fastconv.c"],
            extra_compile_args=["-O3"],
        ),
    ],
)
