#!/usr/bin/env python3
"""Time the port's reads (jubatus_tpu_torch/ops/sparse.py batch_scores for
classify, row_scores for estimate) against their unflushed forms on one
CUDA card, to show what flushing float32 subnormals costs a read.

    python3 scripts/torch_read_ab.py [--calls N] [--out FILE]

Each form is called as a driver calls it for a one-datum read: the
padded [8, 16] index and value arrays go from the host to the card, the
read runs on a [32, 2^20] (classify) or [2^20] (estimate) table, and the
scores come back to the host.  Four forms, in turns (unflushed,
flush_where, flush, flush_checked, flush_checked, flush, flush_where,
unflushed), each timed on the host clock as the median of N calls:
  unflushed      the reads without any flush (an einsum for classify, a
                 product and sum for estimate);
  flush_where    every flush as torch.where(|x| < tiny, x * 0, x), four
                 elementwise ops;
  flush          ops/sparse.py as it is (two elementwise ops a flush);
  flush_checked  flush, with the estimate's sum first checking its terms
                 for one below 2^-103 (sparse.ftz_sum's test, which
                 reads one bool back; ftz_sum makes it on CPU tensors
                 only), to time what the check would cost on the card.
The flushed forms must agree bitwise, and with the unflushed one within
rtol 1e-5 / atol 1e-6 on these normal inputs.  Prints one `read_ab {...}`
JSON line with the card's name and power limit and writes it to FILE
when given.
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
L, D, B, K = 32, 1 << 20, 8, 16      # the smoke's read: one datum, bucket 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_read_ab: needs a CUDA card", file=sys.stderr)
        return 3
    from jubatus_tpu_torch.ops import sparse

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    tiny = torch.finfo(torch.float32).tiny

    def ftz_where(x):
        return torch.where(x.abs() < tiny, x * 0, x)

    def checked_sum(p):
        if bool(((p != 0) & (p.abs() < 2.0 ** -103)).any()):
            raise AssertionError("torch_read_ab: a term below 2^-103")
        return sparse.ftz(p.sum(dim=-1))

    forms = {
        "unflushed": {
            "classify": lambda w, i, v: torch.einsum("lbk,bk->bl",
                                                     w[:, i], v),
            "estimate": lambda w, i, v: (w[i] * v).sum(dim=-1)},
        "flush_where": {
            "classify": lambda w, i, v: ftz_where(ftz_where(
                ftz_where(w[:, i]) * ftz_where(v)).sum(dim=-1).T),
            "estimate": lambda w, i, v: ftz_where(ftz_where(
                ftz_where(w[i]) * ftz_where(v)).sum(dim=-1))},
        "flush": {"classify": sparse.batch_scores,
                  "estimate": sparse.row_scores},
        "flush_checked": {
            "classify": sparse.batch_scores,
            "estimate": lambda w, i, v: checked_sum(sparse.ftz(
                sparse.ftz(w[i]) * sparse.ftz(v)))},
    }
    rng = np.random.default_rng(5)
    tables = {"classify": torch.from_numpy(
                  (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
              ).to(dev),
              "estimate": torch.from_numpy(
                  (rng.standard_normal(D) * 0.1).astype(np.float32)).to(dev)}
    idx = rng.integers(0, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    idx[1:] = 0                          # the padding rows of a bucket
    val[1:] = 0.0

    def call(read, w):
        i = torch.from_numpy(idx).to(dev).long()
        v = torch.from_numpy(val).to(dev)
        return read(w, i, v).cpu().numpy()

    def median_ms(read, w):
        for _ in range(20):
            call(read, w)
        lat = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            call(read, w)
            lat.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(lat))

    result = {"card": card, "shape": {"L": L, "D": D, "B": B, "K": K},
              "calls": args.calls, "torch": torch.__version__}
    ok = True
    for read, w in tables.items():
        outs = {name: call(f[read], w) for name, f in forms.items()}
        same = all(np.array_equal(outs["flush"].view(np.int32),
                                  outs[name].view(np.int32))
                   for name in ("flush_where", "flush_checked"))
        close = bool(np.allclose(outs["flush"], outs["unflushed"],
                                 rtol=1e-5, atol=1e-6))
        ok &= same and close
        turns = [[name, median_ms(forms[name][read], w)]
                 for name in ("unflushed", "flush_where", "flush",
                              "flush_checked", "flush_checked", "flush",
                              "flush_where", "unflushed")]
        result[read] = {"flushed_forms_bitwise": same,
                        "close_to_unflushed": close, "turns_ms": turns}
        print(f"read_ab: {read}: {turns}", flush=True)
    result["ok"] = ok
    line = "read_ab " + json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
