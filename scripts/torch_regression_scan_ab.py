#!/usr/bin/env python3
"""Time the port's regression train-scan kernel (jubatus_tpu_torch/csrc/
regression_scan.cu) against an earlier version of it on one CUDA card,
check that both leave bitwise-equal weights, sweep its block, ring and
producer warps, and split the cycles of both by stage.

    python3 scripts/torch_regression_scan_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
jubatus_tpu_torch/csrc/regression_scan.cu has the one-warp C entry point
regression_scan_launch(w, indices, values, targets, mask, B, K, method,
c, eps, stream), or the replica grid's regression_scan_grid_launch (run
at one block and the current plan); where it also has
regression_scan_launch_profiled (the one-warp arguments, then a long
long[5] of cycles) or regression_scan_grid_launch_profiled, its stage
split is printed too.  Both kernels are built with the current kernel's flags
(flags("regression_scan") of jubatus_tpu_torch/kernels/build.py,
-ftz=true included) and timed by CUDA events at the main path's shape
(B 8192, K 16, D 2^20) for PA, PA1 and PA2 on chip_smoke.py's
random-column microbatch and its shared-column stream (reg_scan_inputs),
in turns (earlier, current, current, earlier), each turn from a fresh w.
The PTX of both scans is checked for float32 arithmetic without .ftz.
Prints one `regression_scan_ab {...}` JSON line (with the card's name
and power limit) and writes it to FILE when given; exits 1 if the two
kernels' weights differ in any bit or an f32 operation lacks .ftz.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METHODS = ("PA", "PA1", "PA2")
EPS, C = 0.1, 1.0              # the shipped PA config's sensitivity, C
# stages of the profiled entries' cycle accounting
EARLIER_STAGES = ("gather", "reductions", "step", "group", "add_store")
CONSUMER = ("wait_block", "forward", "table_reads", "reduction", "step",
            "group_adds", "syncwarp", "block_commit")
PRODUCER = ("wait_free_slot", "hash", "lookup_gather", "per_datum",
            "commit")
WRITEBACK = ("wait_done", "store")
EARLIER_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# the replica grid's profiled entry, run at one block: B, K, D, ndp,
# method, c, eps, T, S, P, stream, prof
CURRENT_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
F32_OP = re.compile(r"^\s*(?:@!?%p\d+\s+)?((?:add|sub|mul|div|fma|setp|abs|"
                    r"neg|min|max|sqrt|rcp)\.[\w.]*f32)\b", re.M)


def ptx_ftz(build, name: str) -> dict:
    """float32 arithmetic and comparisons in the PTX of kernel `name` at
    its flags: counts by instruction, and those without .ftz."""
    extra = [f for f in build.flags(name)
             if f.startswith("-ftz") or f.startswith("-std")]
    out = build.BUILD_DIR / f"{name}.ptx"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=compute_90a", "-O3", *extra,
                    "-ptx", "-o", str(out), str(build.SRC_DIR / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    ops = collections.Counter(F32_OP.findall(out.read_text()))
    return {"ops": dict(ops),
            "without_ftz": sorted(o for o in ops if ".ftz" not in o)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernel")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_regression_scan_ab: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as smoke
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.models import regression as tr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    B, K, D = smoke.REQ_B, 16, 1 << 20
    earlier = build.load_variant("regression_scan", os.path.join(
        args.earlier, "jubatus_tpu_torch", "csrc", "regression_scan.cu"),
        "earlier")
    # a grid-era kernel: the grid entries at one block, the current plan
    gridded = hasattr(earlier, "regression_scan_grid_launch")
    earlier_launch = (earlier.regression_scan_grid_launch if gridded
                      else earlier.regression_scan_launch)
    earlier_launch.argtypes = CURRENT_ARGS[:-1] if gridded else EARLIER_ARGS
    earlier_launch.restype = ctypes.c_int
    earlier_prof = getattr(earlier, "regression_scan_grid_launch_profiled"
                           if gridded else "regression_scan_launch_profiled",
                           None)
    if earlier_prof is not None:
        earlier_prof.argtypes = (CURRENT_ARGS if gridded
                                 else EARLIER_ARGS + [ctypes.c_void_p])
        earlier_prof.restype = ctypes.c_int
    lib = build.load("regression_scan")
    lib.regression_scan_grid_launch_profiled.argtypes = CURRENT_ARGS
    lib.regression_scan_grid_launch_profiled.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def run_earlier(method, prof=None):
        def run(w, batch):
            ptrs = [t.data_ptr() for t in [w] + batch]
            head = (B, K, D, 1) if gridded else (B, K)
            tail = tr.reg_scan_plan(K) if gridded else ()
            mid = METHODS.index(method)
            if prof is None:
                err = earlier_launch(*ptrs, *head, mid, C, EPS, *tail,
                                     stream())
            else:
                err = earlier_prof(*ptrs, *head, mid, C, EPS, *tail,
                                   stream(), prof.data_ptr())
            build.check(err, "earlier regression_scan launch")
        return run

    def run_current(method, plan=None, prof=None):
        plan = plan or tr.reg_scan_plan(K)

        def run(w, batch):
            build.check(lib.regression_scan_grid_launch_profiled(
                *[t.data_ptr() for t in [w] + batch], B, K, D, 1,
                METHODS.index(method), C, EPS, *plan, stream(),
                None if prof is None else prof.data_ptr()),
                "current regression_scan launch")
        return run

    inputs = {
        "random_columns": lambda: smoke.reg_scan_inputs(torch, np, dev, B,
                                                        14),
        "shared_column": lambda: smoke.reg_scan_inputs(torch, np, dev, B, 13,
                                                       shared=True),
    }

    def timed(fn, make, reps=5):
        w, batch = make()
        return smoke.time_cuda(torch, lambda: fn(w, batch), reps)

    def cycles(fn, make, n, names, offset=0):
        prof = torch.zeros(24, dtype=torch.int64, device=dev)
        w, batch = make()
        fn(prof)(w, batch)
        p = prof.cpu().tolist()
        return {k: v / B for k, v in zip(names, p[offset:offset + n])}

    plan = tr.reg_scan_plan(K)
    ptx = {name: ptx_ftz(build, name)
           for name in ("regression_scan", "train_scan")}
    result = {"card": card, "shape": [B, K, D], "c": C, "eps": EPS,
              "plan": {"T": plan[0], "S": plan[1], "P": plan[2]},
              "flags": list(build.flags("regression_scan")), "ptx": ptx}
    bitwise_ok = True
    for name, make in inputs.items():
        res = {"methods": {}}
        for method in METHODS:
            outs = []
            for fn in (run_earlier(method), run_current(method)):
                w, batch = make()
                fn(w, batch)
                outs.append(w)
            torch.cuda.synchronize()
            same = torch.equal(outs[0].view(torch.int32),
                               outs[1].view(torch.int32))
            bitwise_ok &= same
            ndiff = int((outs[0].view(torch.int32)
                         != outs[1].view(torch.int32)).sum())
            del outs
            turns = [[who, timed(run_earlier(method) if who == "earlier"
                                 else run_current(method), make)]
                     for who in ("earlier", "current", "current", "earlier")]
            res["methods"][method] = {"bitwise_equal": same,
                                      "words_differing": ndiff,
                                      "turns_ms": turns}
            print(f"regression_scan_ab: {name} {method}: bitwise "
                  f"{same}, turns {turns}", flush=True)
        sweep = []
        for t in (8, 16, 32, 64, 128):
            for s in (2, 4):
                if tr.reg_scan_smem_bytes(t, s, K) > tr.REG_SMEM_LIMIT:
                    continue
                for p in (1, 2, 3, 4, 6, 8):
                    ms = timed(run_current("PA", (t, s, p)), make)
                    sweep.append({"T": t, "S": s, "P": p, "ms": ms,
                                  "us_per_datum": ms * 1e3 / B})
        res["sweep"] = sweep
        res["current_cycles_per_datum"] = {
            "consumer": cycles(lambda pr: run_current("PA", plan, pr), make,
                               8, CONSUMER),
            "producer": cycles(lambda pr: run_current("PA", plan, pr), make,
                               5, PRODUCER, 8),
            "writeback": cycles(lambda pr: run_current("PA", plan, pr), make,
                                2, WRITEBACK, 16)}
        if earlier_prof is not None:
            res["earlier_cycles_per_datum"] = cycles(
                lambda pr: run_earlier("PA", pr), make,
                *((8, CONSUMER) if gridded else (5, EARLIER_STAGES)))
        result[name] = res
    result["bitwise_equal"] = bitwise_ok
    line = "regression_scan_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    missing = {n: r["without_ftz"] for n, r in ptx.items() if r["without_ftz"]}
    if missing:
        print(f"regression_scan_ab: f32 operations without .ftz: {missing}",
              file=sys.stderr)
    return 0 if bitwise_ok and not missing else 1


if __name__ == "__main__":
    sys.exit(main())
