#!/usr/bin/env python3
"""Time K5, the all-rows count sweep (jubatus_tpu_torch/csrc/lsh.cu
sig_counts), of an earlier checkout against the current one on one CUDA
card, in turns, beside torch.cdist and the bound, and check that the two
kernels give the same bits.

    python3 scripts/torch_counts_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
jubatus_tpu_torch/csrc/lsh.cu has the entry point sig_counts_launch with
the current signature; it is built with the current lsh kernel's flags
(kernels/build.py load_variant).  Shapes: the kinds lsh H 64 (2 words a
row), lsh H 512 (16), minhash H 64 (64) and euclid_lsh H 64 (2); tables of
16,384 rows (the anomaly LOF's served table) and 10^6 rows; 1 and 64
queries.  Each runs in turns (earlier, current, current, earlier);
`device_ms` is 10 calls captured in a CUDA graph and replayed between
CUDA events (the card's time alone; chip_smoke.time_device).  Beside
them: torch.cdist(queries, rows, p=0), one PyTorch call that counts
differing elements, over chip_smoke.cdist_layout's float32 bits (lsh,
euclid_lsh) or float64 words (minhash), laid out before the timed
window; and the bound by class, chip_smoke.counts_bound (the table,
norms and queries read once and [NQ, R] written once; popcounts, int32
operations, euclid_lsh's float32 operations and sqrt).  Prints one
`counts_ab {...}` JSON line with the card's name and power limit and
writes it to FILE when given; exits 1 if the two kernels' outputs differ
anywhere.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KINDS = (("lsh", 64), ("lsh", 512), ("minhash", 64), ("euclid_lsh", 64))
ROWS = (16384, 10 ** 6)
QUERIES = (1, 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernel")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import lsh as L

    if not torch.cuda.is_available():
        print("torch_counts_ab: needs a CUDA card", file=sys.stderr)
        return 2

    def graph_ms(fn):
        ms, how = smoke.time_device(torch, fn, 10)
        if ms is None:
            raise RuntimeError(f"torch_counts_ab: no device time: {how}")
        return ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = os.path.join(args.earlier, "jubatus_tpu_torch", "csrc", "lsh.cu")
    earlier = build.load_variant("lsh", src, "earlier")
    c_p, c_ll, c_i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    earlier.sig_counts_launch.argtypes = ([c_p] * 5 + [c_ll] + [c_i] * 3
                                          + [c_p] * 2)
    earlier.sig_counts_launch.restype = c_i
    dev = torch.device("cuda")

    def old(kind, h, table, qs, norms, qn):
        r, w = table.shape
        nq = qs.shape[0]
        euclid = kind == "euclid_lsh"
        out = torch.empty((nq, r), dtype=torch.float32 if euclid
                          else torch.int32, device=dev)
        tab = L._euclid_cos_dev(h, dev) if euclid else norms
        build.check(earlier.sig_counts_launch(
            table.data_ptr(), qs.data_ptr(), norms.data_ptr(),
            qn.data_ptr(), tab.data_ptr(), r, w, nq, L.SIG_KINDS.index(kind),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "earlier sig_counts")
        return out

    shapes, equal = [], True
    for kind, h in KINDS:
        w = L.sig_width(kind, h)
        for r in ROWS:
            rng = np.random.default_rng(r + h)
            tab_np = rng.integers(0, 2 ** 32, (r, w), dtype=np.uint32)
            if kind == "minhash":
                tab_np %= 5
            table = torch.from_numpy(tab_np.view(np.int32)).to(dev)
            norms = torch.from_numpy((rng.random(r) * 4).astype(
                np.float32)).to(dev)
            del tab_np
            for nq in QUERIES:
                rows = torch.from_numpy(rng.integers(0, r, nq)).to(dev)
                qs = table[rows].clone()
                qs[:, 0] ^= 3
                qn = norms[rows].clone()
                a = old(kind, h, table, qs, norms, qn)
                b = L.sig_counts(kind, table, qs, norms, qn, h)
                same = torch.equal(a.view(torch.int32), b.view(torch.int32))
                ms = {"earlier": [], "current": []}
                for who in ("earlier", "current", "current", "earlier"):
                    fn = ((lambda: old(kind, h, table, qs, norms, qn))
                          if who == "earlier" else
                          (lambda: L.sig_counts(kind, table, qs, norms, qn,
                                                h)))
                    ms[who].append(graph_ms(fn))
                equal &= same
                xq = smoke.cdist_layout(torch, kind, h, qs)
                xr = smoke.cdist_layout(torch, kind, h, table)
                lib_ms = graph_ms(lambda: torch.cdist(xq, xr, p=0))
                lib_ok = torch.equal(
                    torch.cdist(xq, xr, p=0).round().to(torch.int32),
                    (h - b) if kind == "minhash" else
                    L.sig_counts("lsh", table, qs, norms, qn, h))
                del xq, xr
                classes = smoke.counts_bound(kind, r, w, nq)
                by = max(classes, key=classes.get)
                shapes.append({
                    "kind": kind, "hash_num": h, "w": w, "rows": r,
                    "nq": nq, "device_ms": ms,
                    "plan": L.sig_counts_plan(kind, r, h, nq,
                                              table_ptr=table.data_ptr()),
                    "library_ms": lib_ms,
                    "library": "torch.cdist(p=0)", "library_counts": lib_ok,
                    "bound_ms": classes[by], "bound_by": by,
                    "bound_classes_ms": classes, "equal": same})
                print(f"counts_ab: {shapes[-1]}", flush=True)
            del table, norms
            torch.cuda.empty_cache()
    result = {"card": card, "torch": torch.__version__, "equal": equal,
              "shapes": shapes}
    line = "counts_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
