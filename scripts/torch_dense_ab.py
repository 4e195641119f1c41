#!/usr/bin/env python3
"""Time K4's exact sweeps of an earlier checkout against the current ones
(jubatus_tpu_torch/csrc/lsh.cu dense_dots and dense_topk) on one CUDA
card, in turns, beside torch.sparse.mm and torch.topk, and check that the
two kernels give the same bits.

    python3 scripts/torch_dense_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
jubatus_tpu_torch/csrc/lsh.cu has the entry points dense_dots_launch,
dense_topk_workspace and dense_topk_launch with the current signatures;
it is built with the current lsh kernel's flags (kernels/build.py
load_variant).  Shapes (the tables of chip_smoke.py's phase 11a: 16
standard-normal features a row of Kr 32, the rest padding):
  dense_dots at the exact LOF's sweep (1,024 rows, D 2^16: the query
  gathered from L2), at a small LOF table (64 rows) and at 10^6 rows
  (D 4096), one query each, and at the 10^6-row table's bytes as 5 x
  10^5 rows of Kr 64 (a lane a row, as dense_topk's sweep runs, where
  Kr 32 runs 8 lanes a row);
  dense_topk at 10^6 rows (D 4096, 1% holes in the mask, one query) at
  kb 16 for cosine and euclid, and at kb 2048 (the sort path: every row's
  key, then the bitonic sort).
Each runs in turns (earlier, current, current, earlier): `device_ms` is
10 calls captured in a CUDA graph and replayed between CUDA events (the
card's time alone; the 10^6-row tables, 256 MB, do not stay in the 50 MB
L2 from one call to the next, the LOF's do, as they do between a
server's adds).  Beside them the library call over the same inputs
(torch.sparse.mm of the table as CSR against the query, or torch.topk of
ready scores) and the bytes bound (the table, norms and mask read once,
the query's entries at the table's distinct indices read once, the
output written once, at 3.35 TB/s).  Prints one `dense_ab {...}`
JSON line with the card's name and power limit and writes it to FILE
when given; exits 1 if the two kernels' outputs differ anywhere (the
rows are normal, so no dot sums to a zero, whose sign at Kr 32 the
current kernel gives as XLA's vectorized loop starts its lanes).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KR, NNZ = 32, 16                # the stores' rows: Kr 32, 16 features
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet


def graph_ms(torch, fn, calls=10, replays=3):
    """Device ms a call: `calls` calls captured into one CUDA graph after a
    warm-up, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * calls)


def sparse_rows(torch, np, dev, r, d, seed, kr=KR):
    """The phase-11a table: [r, kr] of NNZ features a row, and norms."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((r, kr), np.int32)
    val = np.zeros((r, kr), np.float32)
    idx[:, :NNZ] = rng.integers(0, d, (r, NNZ))
    val[:, :NNZ] = rng.standard_normal((r, NNZ))
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (idx, val, norms)]


def gathered_query_bytes(torch, idx):
    """The bytes of one dense query that a sweep of the table idx must
    read: the entries at its distinct indices, not the whole query."""
    return torch.unique(idx).numel() * 4


def bind(lib):
    """dense_* entry points of an lsh library, as ops/lsh.py binds them."""
    c_p, c_ll, c_i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dense_topk_launch.argtypes = ([c_p] * 3 + [c_ll] + [c_p] * 3 + [c_ll]
                                      + [c_i] * 5 + [c_p] + [c_ll] + [c_p] * 2)
    lib.dense_topk_launch.restype = c_i
    lib.dense_topk_workspace.argtypes = [c_ll] + [c_i] * 4 + [c_ll]
    lib.dense_topk_workspace.restype = c_ll
    lib.dense_dots_launch.argtypes = [c_p] * 3 + [c_ll] + [c_i] * 3 + [c_p] * 2
    lib.dense_dots_launch.restype = c_i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernel")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import lsh as L

    if not torch.cuda.is_available():
        print("torch_dense_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = os.path.join(args.earlier, "jubatus_tpu_torch", "csrc", "lsh.cu")
    libs = {"earlier": bind(build.load_variant("lsh", src, "earlier")),
            "current": L._lib()}
    dev = torch.device("cuda")

    def dots(who, idx, val, q):
        out = torch.empty((q.shape[0], idx.shape[0]), dtype=torch.float32,
                          device=dev)
        build.check(libs[who].dense_dots_launch(
            idx.data_ptr(), val.data_ptr(), q.data_ptr(), idx.shape[0],
            idx.shape[1], q.shape[1], q.shape[0], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), f"{who} dense_dots")
        return out

    def topk(who, metric, idx, val, norms, mask, q, qn, kb):
        lib, r, nq = libs[who], idx.shape[0], q.shape[0]
        ws_bytes = lib.dense_topk_workspace(r, KR, q.shape[1], nq, kb, r)
        ws = torch.empty(max(ws_bytes, 8), dtype=torch.uint8, device=dev)
        out = torch.empty((nq, kb), dtype=torch.int64, device=dev)
        build.check(lib.dense_topk_launch(
            idx.data_ptr(), val.data_ptr(), norms.data_ptr(), r,
            mask.data_ptr(), q.data_ptr(), qn.data_ptr(), r, KR, q.shape[1],
            nq, L.DENSE_METRICS.index(metric), kb, ws.data_ptr(), ws_bytes,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            f"{who} dense_topk")
        return out

    def turns(fns):
        ms = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            ms[who].append(graph_ms(torch, fns[who]))
        return ms

    shapes, equal = [], True
    for r, d, kr in ((1024, 1 << 16, KR), (64, 1 << 16, KR),
                     (10 ** 6, 4096, KR), (5 * 10 ** 5, 4096, 2 * KR)):
        idx, val, _ = sparse_rows(torch, np, dev, r, d, 23, kr)
        q = torch.from_numpy(np.random.default_rng(r).standard_normal(
            (1, d)).astype(np.float32)).to(dev)
        a, b = dots("earlier", idx, val, q), dots("current", idx, val, q)
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        equal &= same
        crow = torch.arange(0, r * kr + 1, kr, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # CSR's beta notice
            csr = torch.sparse_csr_tensor(crow, idx.reshape(-1).long(),
                                          val.reshape(-1), (r, d),
                                          check_invariants=False)
        qt = q.T.contiguous()
        ms = turns({w: (lambda w=w: dots(w, idx, val, q))
                    for w in ("earlier", "current")})
        nbytes = r * kr * 8 + gathered_query_bytes(torch, idx) + r * 4
        shapes.append({
            "kernel": "dense_dots", "rows": r, "kr": kr, "d": d, "c": 1,
            "device_ms": ms,
            "library_ms": graph_ms(torch, lambda: torch.sparse.mm(csr, qt)),
            "library": "torch.sparse.mm (CSR)",
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "equal": same})
        print(f"dense_ab: {shapes[-1]}", flush=True)
        del idx, val, csr
    r, d = 10 ** 6, 4096
    idx, val, norms = sparse_rows(torch, np, dev, r, d, 22)
    rng = np.random.default_rng(21)
    mask = torch.from_numpy(rng.random(r) >= 0.01).to(dev)
    q = torch.from_numpy(rng.standard_normal((1, d)).astype(
        np.float32)).to(dev)
    qn = torch.sqrt((q * q).sum(1))
    scores = torch.from_numpy(np.random.default_rng(1).random(
        (1, r), dtype=np.float32)).to(dev)
    for metric, kb in (("cosine", 16), ("euclid", 16), ("cosine", 2048)):
        a = topk("earlier", metric, idx, val, norms, mask, q, qn, kb)
        b = topk("current", metric, idx, val, norms, mask, q, qn, kb)
        same = torch.equal(a, b)
        equal &= same
        ms = turns({w: (lambda w=w: topk(w, metric, idx, val, norms, mask,
                                         q, qn, kb))
                    for w in ("earlier", "current")})
        nbytes = (r * KR * 8 + r * 4 + r + gathered_query_bytes(torch, idx)
                  + 4 + kb * 8)
        shapes.append({
            "kernel": "dense_topk", "rows": r, "kr": KR, "d": d, "nq": 1,
            "metric": metric, "kb": kb, "holes": 0.01, "device_ms": ms,
            "library_ms": graph_ms(torch, lambda: torch.topk(scores, kb)),
            "library": "torch.topk of ready scores",
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "equal": same})
        print(f"dense_ab: {shapes[-1]}", flush=True)
    result = {"card": card, "torch": torch.__version__, "equal": equal,
              "shapes": shapes}
    line = "dense_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
