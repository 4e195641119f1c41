"""jubatus_tpu_torch — the PyTorch/CUDA port of jubatus_tpu.

The JAX package (jubatus_tpu/) is the reference; this package mirrors its
module paths so each counterpart is found under the same name
(jubatus_tpu_torch/models/classifier.py <-> jubatus_tpu/models/classifier.py).
It imports torch, numpy, msgpack and the stdlib only — never jax and never
jubatus_tpu.

What it holds: the classifier and regression servers with their wire
train loops (native raw-frame ingest into pinned arenas) and read RPCs,
the nearest_neighbor server (lsh, minhash, euclid_lsh over a paged
signature table, jax's threefry draws bit for bit),
the recommender and anomaly servers, standalone or in a cluster
(coordinator, membership, MIX rounds between processes, JAX servers
included), the partition plane of the row engines (--routing partition)
behind the port's own proxy, the driver-level MIX diff algebra and the
blockwise-int8 (v3) MIX wire.
Model state lives on one torch device (CUDA unless the caller asks for
the CPU); the hot loops are hand-written CUDA kernels (csrc/), each with
a plain PyTorch version beside its wrapper.

  fv/        feature-vector converter (pure-Python copy) + native eligibility
  native/    C FastConverter and FrameSplitter (built by cc at first use)
  ops/       sparse gather/scatter primitives as torch ops; LSH signatures,
             the signature-table sweep and top-k (kernel wrappers + plain
             versions)
  csrc/      CUDA C++ kernels for sm_90a; kernels/build.py builds them
  parallel/  blockwise int8 quantizer (kernel wrappers + plain versions)
  batching/  shape buckets, the window controller, pinned arena pool
  models/    driver protocol, the classifier, regression and
             nearest_neighbor drivers, the paged row store; carry.py
             moves state across packages
  mix/       msgpack diff codec, the v3 wire encode, the mixers
  rpc/       lean asyncio msgpack-RPC server (old-spec wire) and client
  cluster/   coordinator, lock-service client, membership
  framework/ service tables, server object, ingest pipeline, model files,
             the partition plane and the proxy
  cli/       `python -m jubatus_tpu_torch.cli.server`, `... .cli.proxy`
"""

__version__ = "0.9.2"  # tracks the reference wire/model-format version

VERSION_MAJOR = 0
VERSION_MINOR = 9
VERSION_MAINTENANCE = 2
