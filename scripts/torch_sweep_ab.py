#!/usr/bin/env python3
"""Time a nearest-neighbor read's device work with an earlier sweep kernel
(one int64 key per query and row, then torch.topk over the keys and two
copies out) against the current one (jubatus_tpu_torch/csrc/lsh.cu K3
sig_topk: the sweep with its top-kb selection, one copy out) on one
CUDA card, and check that both give the same rows and scores.

    python3 scripts/torch_sweep_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
jubatus_tpu_torch/csrc/lsh.cu has the unfused entry point
sig_sweep_launch(table, norms, count, qsigs, qnorms, qrows, tab, R, W,
NQ, kind, keys, stream).  It is built with the current lsh kernel's
flags.  Shapes, each at 1 and 64 queries and kb 16 (a read of size 10):
the servers' table of chip_smoke.py's phase 10 (2,000,128 slots,
1,001,024 valid, lsh H 64; here the signatures of random 16-feature
datums made by K1), and 10^6 rows of lsh H 64, euclid_lsh H 512 and
minhash H 64 (random words, as chip_smoke.py's).  Each shape runs in
turns (earlier, current, current, earlier): `read_ms` is CUDA events
around calls that end in the host copy (a read's device work and its
host's part), `device_ms` the same work without the copies: at one query
captured in a CUDA graph and replayed (the card's time alone), at 64
CUDA events around calls (the card's time dominates there).  Prints one
`sweep_ab {...}` JSON line (with the card's name and power limit) and
writes it to FILE when given; exits 1 if the two kernels' rows or
scores differ anywhere.
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
KB = 16
SERVED = (2000128, 1001024)     # the servers' slots and valid rows
ROWS = 10 ** 6
EARLIER_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_void_p] * 2)


def graph_ms(torch, fn, calls=10, replays=3):
    """Device ms a call: `calls` calls captured into one CUDA graph after a
    warm-up, replayed between CUDA events; (None, reason) where capture
    fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
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
        return a.elapsed_time(b) / (replays * calls), "cuda_graph"
    except Exception as e:  # noqa: BLE001 - reported, not hidden
        torch.cuda.synchronize()
        return None, f"capture failed: {type(e).__name__}: {e}"[:200]


def events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def tables(torch, np, L, dev):
    """(name, kind, hash_num, table, norms, valid rows) of every shape."""
    rng = np.random.default_rng(10)
    r, n = SERVED
    served = torch.zeros((r, 2), dtype=torch.int32, device=dev)
    key = L.prng_key(0x1EAF)
    for s in range(0, n, 4096):
        b = min(4096, n - s)
        idx = torch.from_numpy(rng.integers(0, 4096, (b, 16)).astype(
            np.int32)).to(dev)
        val = torch.from_numpy(rng.standard_normal((b, 16)).astype(
            np.float32)).to(dev)
        served[s:s + b] = L.lsh_signature(key, idx, val, 64)
    out = [("served", "lsh", 64, served,
            torch.zeros(r, dtype=torch.float32, device=dev), n)]
    for kind, h in (("lsh", 64), ("euclid_lsh", 512), ("minhash", 64)):
        w = L.sig_width(kind, h)
        if kind == "minhash":
            t = rng.integers(0, 8, (ROWS, w), dtype=np.int32)
        else:
            t = rng.integers(-2 ** 31, 2 ** 31, (ROWS, w),
                             dtype=np.int64).astype(np.int32)
        norms = (rng.random(ROWS) * 4).astype(np.float32)
        out.append((f"{kind}_{h}", kind, h, torch.from_numpy(t).to(dev),
                    torch.from_numpy(norms).to(dev), ROWS))
    return out


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
        print("torch_sweep_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = os.path.join(args.earlier, "jubatus_tpu_torch", "csrc", "lsh.cu")
    old = build.load_variant("lsh", src, "earlier")
    old.sig_sweep_launch.argtypes = EARLIER_ARGS
    old.sig_sweep_launch.restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def earlier_top(kind, h, table, norms, n, qs, qn):
        r, w = table.shape
        keys = torch.empty((qs.shape[0], r), dtype=torch.int64, device=dev)
        tab = L._count_table_dev(kind, h, dev)
        build.check(old.sig_sweep_launch(
            table.data_ptr(), norms.data_ptr(), n, qs.data_ptr(),
            qn.data_ptr(), 0, tab.data_ptr(), r, w, qs.shape[0],
            L.SIG_KINDS.index(kind), keys.data_ptr(), stream),
            "earlier sig_sweep launch")
        return torch.topk(keys, KB, dim=1, largest=True, sorted=True).values

    def current_top(kind, h, table, norms, n, qs, qn):
        return L.sig_topk(kind, table, norms, n, q_sigs=qs, qnorms=qn,
                          hash_num=h, kb=KB)

    def earlier_read(*a):
        rows, scores = L.keys_to_rows_scores(earlier_top(*a))
        return rows.cpu().numpy(), scores.cpu().numpy()

    def current_read(*a):
        return L.keys_to_host(current_top(*a))

    shapes, equal = [], True
    rng = np.random.default_rng(11)
    for name, kind, h, table, norms, n in tables(torch, np, L, dev):
        for nq in (1, 64):
            q_rows = torch.from_numpy(rng.integers(0, n, nq)).to(dev)
            qs, qn = table[q_rows].contiguous(), norms[q_rows].contiguous()
            a = (kind, h, table, norms, n, qs, qn)
            er, es = earlier_read(*a)
            cr, cs = current_read(*a)
            same = bool(np.array_equal(er, cr) and np.array_equal(
                es.view(np.uint32), cs.view(np.uint32)))
            equal &= same
            reps = 20 if nq == 1 else 5
            turns = {"earlier": [], "current": []}
            for who in ("earlier", "current", "current", "earlier"):
                fn = earlier_read if who == "earlier" else current_read
                turns[who].append(events_ms(torch, lambda: fn(*a), reps))
            dev_ms = {}
            for who, fn in (("earlier", earlier_top), ("current", current_top),
                            ("current", current_top), ("earlier", earlier_top)):
                if nq == 1:
                    ms, how = graph_ms(torch, lambda: fn(*a))
                else:
                    ms = events_ms(torch, lambda: fn(*a), reps)
                dev_ms.setdefault(who, []).append(ms if ms is not None
                                                  else how)
            shapes.append({
                "shape": name, "kind": kind, "hash_num": h,
                "rows": int(table.shape[0]), "valid": n, "nq": nq, "kb": KB,
                "plan": L.topk_plan(int(table.shape[0]), int(table.shape[1]),
                                    nq, KB, n, kind),
                "read_ms": turns, "device_ms": dev_ms, "equal": same})
            print(f"sweep_ab: {name} Nq {nq}: read earlier "
                  f"{turns['earlier']} ms, current {turns['current']} ms; "
                  f"device earlier {dev_ms['earlier']}, current "
                  f"{dev_ms['current']}; equal {same}", flush=True)
        del table, norms
        torch.cuda.empty_cache()
    result = {"card": card, "torch": torch.__version__, "kb": KB,
              "equal": equal, "shapes": shapes}
    line = "sweep_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
