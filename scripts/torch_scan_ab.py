#!/usr/bin/env python3
"""Time the port's sequential train-scan kernel (jubatus_tpu_torch/csrc/
train_scan.cu) against an earlier version of it on one CUDA card, sweep
its ring depth and producer warps, and split its cycles by stage.

    python3 scripts/torch_scan_ab.py --earlier DIR [--earlier-flags base]
                                     [--method M] [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists); its
jubatus_tpu_torch/csrc/train_scan.cu has the slice-1 C entry point
(train_scan_launch without mode, ring and producers), the planned one
(with them) or the replica grid's (train_scan_grid_launch, run at one
block); the last two run at the current plan.  Both kernels are built with
the current kernel's flags (flags("train_scan") of
jubatus_tpu_torch/kernels/build.py, -ftz=true included), or the earlier
one without -ftz=true under --earlier-flags base (an A/B of one source
then times the flush itself), and timed by CUDA events at the main
path's shape (AROW, or --method, B 8192, K 16, L 32, D 2^20) on two
microbatches:
chip_smoke.py's random-column batch and its shared-column stream.  The
earlier and current kernels run in turns (earlier, current, current,
earlier), each from a fresh state.  The stage split comes from
train_scan_grid_launch_profiled at one block (clock64 sums of the
consumer warp and the first producer warp).  Prints one `scan_ab {...}` JSON line
(with the card's name and power limit) and writes it to FILE when given.
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
# stages of train_scan_grid_launch_profiled's cycle accounting
CONSUMER = ("wait_slot", "forward", "scores_argmax", "step_sizes", "updates",
            "commit")
PRODUCER = ("wait_free_slot", "stage", "gather")
WRITEBACK = ("wait_commit", "store")
MARGIN = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")
EARLIER_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p])
PLANNED_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
# the replica grid's entries: one more int, the replicas (blocks)
CURRENT_ARGS = PLANNED_ARGS[:-2] + [ctypes.c_int] + PLANNED_ARGS[-2:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernel")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--method", default="AROW", choices=MARGIN,
                    help="margin method of the timed scan")
    ap.add_argument("--earlier-flags", choices=("current", "base"),
                    default="current",
                    help="build the earlier kernel with the current "
                         "kernel's flags (default) or with the common "
                         "NVCC_FLAGS alone (no -ftz=true), to time the "
                         "flush itself")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_ab: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as smoke
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.models import classifier as tc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    L, K, D, B = smoke.N_LABELS, 16, 1 << 20, smoke.REQ_B
    aid = tc._METHOD_ID[args.method]
    has_cov = tc._has_cov(args.method)
    earlier_flags = (build.NVCC_FLAGS if args.earlier_flags == "base"
                     else build.flags("train_scan"))
    earlier = build.load_variant("train_scan", os.path.join(
        args.earlier, "jubatus_tpu_torch", "csrc", "train_scan.cu"),
        "earlier", earlier_flags)
    # an earlier kernel with the planned entry point runs at the current
    # plan
    planned = hasattr(earlier, "train_scan_smem_bytes")
    # a grid-era kernel: the grid entries at one block
    gridded = hasattr(earlier, "train_scan_grid_launch")
    earlier_launch = (earlier.train_scan_grid_launch if gridded
                      else earlier.train_scan_launch)
    earlier_launch.argtypes = (CURRENT_ARGS[:-1] if gridded
                               else PLANNED_ARGS[:-1] if planned
                               else EARLIER_ARGS)
    earlier_launch.restype = ctypes.c_int
    lib = build.load("train_scan")
    lib.train_scan_grid_launch_profiled.argtypes = CURRENT_ARGS
    lib.train_scan_grid_launch_profiled.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def run_earlier(state, batch):
        plan = ()
        if planned:
            mode, depth = tc.scan_plan(L, K, has_cov, tc.SCAN_RING)
            plan = (mode, depth, min(tc.SCAN_PRODUCERS, depth))
            plan += (1,) if gridded else ()
        build.check(earlier_launch(
            *[t.data_ptr() for t in state + batch], B, K, L, D, aid, 1.0,
            *plan, stream()), "earlier train_scan launch")

    def runner(ring=tc.SCAN_RING, producers=tc.SCAN_PRODUCERS, prof=None,
               kernel=None):
        mode, depth = tc.scan_plan(L, K, has_cov, ring)

        def run(state, batch):
            nprod = min(producers, depth)
            ptr = None if prof is None else prof.data_ptr()
            head = [t.data_ptr() for t in state + batch]
            if kernel is None or hasattr(kernel,
                                         "train_scan_grid_launch_profiled"):
                err = (kernel or lib).train_scan_grid_launch_profiled(
                    *head, B, K, L, D, aid, 1.0, mode, depth, nprod, 1,
                    stream(), ptr)
            else:
                err = kernel.train_scan_launch_profiled(
                    *head, B, K, L, D, aid, 1.0, mode, depth, nprod,
                    stream(), ptr)
            build.check(err, "current train_scan launch")
        return run

    inputs = {
        "random_columns": lambda: smoke.scan_inputs(torch, np, dev, B, 2),
        "shared_column": lambda: smoke.shared_column_inputs(
            torch, np, dev, B, L, K, D),
    }

    def timed(fn, make, reps=3):
        state, batch = make()
        return smoke.time_cuda(torch, lambda: fn(state, batch), reps)

    def stages(make, ring, producers, kernel=None):
        prof = torch.zeros(16, dtype=torch.int64, device=dev)
        state, batch = make()
        runner(ring, producers, prof, kernel)(state, batch)
        p = prof.cpu().tolist()
        return {"ring": ring, "producers": producers,
                "consumer_cycles_per_datum": {
                    k: v / B for k, v in zip(CONSUMER, p[:6])},
                "producer_cycles_per_datum": {
                    k: v / B for k, v in zip(PRODUCER, p[8:11])},
                "writeback_cycles_per_datum": {
                    k: v / B for k, v in zip(WRITEBACK, p[12:14])}}

    result = {"card": card, "shape": [B, K, L, D], "method": args.method,
              "earlier_flags": list(earlier_flags),
              "current_flags": list(build.flags("train_scan")),
              "plan": {"ring": tc.SCAN_RING,
                       "producers": tc.SCAN_PRODUCERS}}
    current = runner()
    for name, make in inputs.items():
        # one launch of each from the same fresh state: the two kernels
        # agree within the scan's tolerance
        outs = []
        for fn in (run_earlier, current):
            state, batch = make()
            fn(state, batch)
            outs.append(state)
        torch.cuda.synchronize()
        diff = max(float((a - b).abs().max())
                   for a, b in zip(outs[0][:2], outs[1][:2]))
        same_ints = all(torch.equal(a, b)
                        for a, b in zip(outs[0][2:], outs[1][2:]))
        del outs
        turns = [[who, timed(run_earlier if who == "earlier" else current,
                             make)]
                 for who in ("earlier", "current", "current", "earlier")]
        sweep = []
        for ring in (1, 2, 3, 4, 6, 8):
            for producers in (1, 2, 4):
                if producers <= ring:
                    ms = timed(runner(ring, producers), make)
                    sweep.append({"ring": ring, "producers": producers,
                                  "ms": ms, "us_per_datum": ms * 1e3 / B})
        split = [stages(make, ring, producers)
                 for ring, producers in ((1, 1), (2, 2), (3, 2), (4, 2))]
        if planned:
            prof_fn = (earlier.train_scan_grid_launch_profiled if gridded
                       else earlier.train_scan_launch_profiled)
            prof_fn.argtypes = CURRENT_ARGS if gridded else PLANNED_ARGS
            prof_fn.restype = ctypes.c_int
            result.setdefault("earlier_stages", {})[name] = stages(
                make, tc.SCAN_RING, tc.SCAN_PRODUCERS, earlier)
        result[name] = {"turns_ms": turns, "sweep": sweep, "stages": split,
                        "earlier_vs_current_max_abs_diff": diff,
                        "counts_active_equal": same_ints}
        print(f"scan_ab: {name}: turns {turns}", flush=True)
    line = "scan_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
