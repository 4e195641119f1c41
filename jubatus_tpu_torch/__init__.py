"""jubatus_tpu_torch — the PyTorch/CUDA port of jubatus_tpu.

The JAX package (jubatus_tpu/) is the reference; this package mirrors its
module paths so each counterpart is found under the same name
(jubatus_tpu_torch/models/classifier.py <-> jubatus_tpu/models/classifier.py).
It imports torch, numpy, msgpack and the stdlib only — never jax and never
jubatus_tpu.

Slice 1 (this tree): the classifier server with its wire train/classify
loop, the driver-level MIX diff algebra and the blockwise-int8 (v3) MIX
wire.  Model state lives on one torch device (CUDA unless the caller asks
for the CPU); the hot loops are hand-written CUDA kernels (csrc/), each
with a plain PyTorch version beside its wrapper.

  fv/        feature-vector converter (pure-Python copy)
  ops/       sparse gather/scatter primitives as torch ops
  csrc/      CUDA C++ kernels for sm_90a; kernels/build.py builds them
  parallel/  blockwise int8 quantizer (kernel wrappers + plain versions)
  models/    driver protocol + the classifier driver; carry.py moves state
             across packages
  mix/       msgpack diff codec + the v3 wire encode
  rpc/       lean asyncio msgpack-RPC server (old-spec wire)
  framework/ service table, server object, model-file save/load
  cli/       `python -m jubatus_tpu_torch.cli.server`
"""

__version__ = "0.9.2"  # tracks the reference wire/model-format version

VERSION_MAJOR = 0
VERSION_MINOR = 9
VERSION_MAINTENANCE = 2
