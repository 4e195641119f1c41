#!/usr/bin/env python3
"""Split K6 and K7 (jubatus_tpu_torch/csrc/candidates.cu sig_probe and
ivf_probe) into their gather-and-rescore and their selection on one CUDA
card: each kernel whole against a variant without its selection, in
turns (whole, split, split, whole), at chip_smoke.py phase 12's shapes.
The variant is made here, at run time, from the shipped source with its
two `block_topk(keys, npad, kb);` calls taken out (the keys are written
unsorted), and built beside the kernels' libraries; the shipped kernels
keep one build.

    python3 scripts/torch_probe_split.py [--ivf-rows N] [--out FILE]

Tables (bench.py:1240-1313's generators, built on the host without a
driver): lsh H 64 at 10^6 rows of 4096 random prototype signatures, one
bit flipped a row, under lsh_probe at 4 probes (index/lsh_probe.py);
inverted_index rows of Kr 32 over 4096 columns, 250,000 rows (or
--ivf-rows) of 4096 prototypes of 16 columns, values jittered by 0.05,
under ivf at 4 probes (index/ivf.py), its host build (k-means and
assignment, `rebuild_from`) timed as `build_s`.  The queries are stored rows (K6 by row, K7 a
row's own features).  `device_ms` is 10 calls captured in a CUDA graph
and replayed between CUDA events (chip_smoke.time_device).  The whole
kernel's result is checked bitwise against its plain version first.
Prints one `probe_split {...}` JSON line with the card's name and power
limit and writes it to FILE when given; exits 1 if a kernel differs from
its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NN_ROWS = 10 ** 6
IVF_ROWS = 250_000        # chip_smoke.py INDEX_IVF_ROWS
SELECT = "  block_topk(keys, npad, kb);\n"
PROTOS = 4096
PROBES = 4
K = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ivf-rows", type=int, default=IVF_ROWS,
                    help="rows of K7's table (default %(default)s)")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    ivf_rows = args.ivf_rows
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from jubatus_tpu_torch.index import IndexSpec, IvfIndex, SigProbeIndex
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import candidates as C

    if not torch.cuda.is_available():
        print("torch_probe_split: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    whole = C._lib()
    with open(os.path.join(ROOT, "jubatus_tpu_torch", "csrc",
                           "candidates.cu")) as f:
        src = f.read()
    if src.count(SELECT) != 2:
        print("torch_probe_split: expected K6's and K7's block_topk "
              "calls in csrc/candidates.cu", file=sys.stderr)
        return 2
    variant = build.BUILD_DIR / "candidates_noselect.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant.write_text(src.replace(SELECT, ""))
    split = C.bind(build.load_variant("candidates", variant, "noselect"))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def turns(fn):
        ms = {"whole": [], "split": []}
        for who in ("whole", "split", "split", "whole"):
            C._lib = (lambda: whole) if who == "whole" else (lambda: split)
            got, how = smoke.time_device(torch, fn, 10)
            if got is None:
                raise RuntimeError(f"torch_probe_split: no device time: "
                                   f"{how}")
            ms[who].append(got)
        C._lib = lambda: whole
        return ms

    rng = np.random.default_rng(17)
    # K6: lsh H 64 at 10^6 rows
    protos = rng.integers(0, 2 ** 32, (PROTOS, 2), dtype=np.uint32)
    sigs = protos[rng.integers(0, PROTOS, NN_ROWS)]
    sigs[np.arange(NN_ROWS), rng.integers(0, 2, NN_ROWS)] ^= \
        np.uint32(1) << rng.integers(0, 32, NN_ROWS, dtype=np.uint32)
    six = SigProbeIndex("lsh", 64, IndexSpec(kind="lsh_probe",
                                             probes=PROBES), put=put)
    six.rebuild_from(np.arange(NN_ROWS), sigs)
    csr = six.device_csr()
    table = put(sigs.view(np.int32))
    norms = put(np.ones(NN_ROWS, np.float32))
    kb = C._kb(K, six.plan, csr[4], csr[3])
    q_rows = torch.tensor([12345], device=dev)
    sargs = ("lsh", table, norms, NN_ROWS, None, csr, six.plan, six.bits,
             64, kb)
    got = C.sig_probe(*sargs, q_rows=q_rows)
    ref = C.sig_probe_ref("lsh", table, norms, NN_ROWS, None, table[q_rows],
                          norms[q_rows], *csr[:4], csr[4], six.plan,
                          six.bits, 64, kb)
    equal = torch.equal(got, ref)
    k6 = {"rows": NN_ROWS, "cap": int(csr[4]), "kb": kb,
          "width": C._cand_width(six.plan, csr[4], csr[3]),
          "n_cand": int(ref[0, 2 * kb]), "equal": equal,
          "device_ms": turns(lambda: C.sig_probe(*sargs, q_rows=q_rows))}
    print(f"probe_split: K6 {k6}", flush=True)
    del table, norms, sigs, six, csr
    # K7: inverted_index, Kr 32, 4096 columns, 250,000 rows
    cl_idx = np.stack([rng.choice(4096, 16, replace=False)
                       for _ in range(PROTOS)]).astype(np.int32)
    cl_val = rng.standard_normal((PROTOS, 16)).astype(np.float32)
    asn = rng.integers(0, PROTOS, ivf_rows)
    idx = np.zeros((ivf_rows, 32), np.int32)
    val = np.zeros((ivf_rows, 32), np.float32)
    idx[:, :16] = cl_idx[asn]
    val[:, :16] = cl_val[asn] + 0.05 * rng.standard_normal(
        (ivf_rows, 16)).astype(np.float32)
    rnorms = np.sqrt((val * val).sum(1)).astype(np.float32)
    ivf = IvfIndex("cosine", IndexSpec(kind="ivf", probes=PROBES), put=put)
    t0 = time.perf_counter()
    ivf.rebuild_from(np.arange(ivf_rows), idx, val)
    build_s = time.perf_counter() - t0
    csr = ivf.device_csr()
    cent = ivf.device_centroids()
    ti, tv, tn = put(idx), put(val), put(rnorms)
    q = 777
    qi, qv = put(idx[q, :16]), put(val[q, :16])
    qd = torch.zeros(4096, dtype=torch.float32, device=dev)
    qd[qi.long()] = qv
    qn = float(rnorms[q])
    probes = min(PROBES, cent.shape[0])
    kb7 = C._ivf_kb(K, probes, csr[4], csr[3])
    iargs = ("cosine", qi, qv, qd, qn, cent, ti, tv, tn, ivf_rows, None, csr,
             probes, 64, kb7)
    got = C.ivf_probe(*iargs)
    ref = C.ivf_probe_ref("cosine", qi, qv, qd, torch.tensor(
        np.float32(qn), device=dev), cent, ti, tv, tn, ivf_rows, None,
        *csr[:4], csr[4], probes, 64, kb7)
    same = torch.equal(got, ref)
    equal &= same
    k7 = {"rows": ivf_rows, "build_s": build_s,
          "centroids": int(cent.shape[0]),
          "cap": int(csr[4]), "kb": kb7,
          "width": 2 * probes * int(csr[4]) + int(csr[3].shape[0]),
          "n_cand": int(ref[0, 2 * kb7]), "equal": same,
          "device_ms": turns(lambda: C.ivf_probe(*iargs))}
    print(f"probe_split: K7 {k7}", flush=True)
    result = {"card": card, "torch": torch.__version__, "equal": equal,
              "sig_probe": k6, "ivf_probe": k7}
    line = "probe_split " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
