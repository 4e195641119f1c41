#!/usr/bin/env python3
"""Time the port's sequential train-scan kernel (jubatus_tpu_torch/csrc/
train_scan.cu) against an earlier version of it on one CUDA card, sweep
its ring depth and producer warps, and split its cycles by stage.

    python3 scripts/torch_scan_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists); its
jubatus_tpu_torch/csrc/train_scan.cu must have the slice-1 C entry point
(train_scan_launch without mode, ring and producers).  Both kernels are
built with the flags of jubatus_tpu_torch/kernels/build.py
and timed by CUDA events at the main path's shape (AROW, B 8192, K 16,
L 32, D 2^20) on two microbatches: chip_smoke.py's random-column batch and
its shared-column stream.  The earlier and current kernels run in turns
(earlier, current, current, earlier), each from a fresh state.  The stage
split comes from train_scan_launch_profiled (clock64 sums of the consumer
warp and the first producer warp).  Prints one `scan_ab {...}` JSON line
(with the card's name and power limit) and writes it to FILE when given.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# stages of train_scan_launch_profiled's cycle accounting
CONSUMER = ("wait_slot", "forward", "scores_argmax", "step_sizes", "updates",
            "commit")
PRODUCER = ("wait_free_slot", "stage", "gather")
WRITEBACK = ("wait_commit", "store")
EARLIER_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p])
CURRENT_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def build_lib(build, src: str, label: str) -> ctypes.CDLL:
    """nvcc `src` with the port's flags into the build directory (reused
    when the source is unchanged)."""
    tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libtrain_scan_{label}-{tag}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


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
    aid = tc._METHOD_ID["AROW"]
    src = str(build.SRC_DIR / "train_scan.cu")
    earlier = build_lib(build, os.path.join(
        args.earlier, "jubatus_tpu_torch", "csrc", "train_scan.cu"),
        "earlier")
    earlier.train_scan_launch.argtypes = EARLIER_ARGS
    earlier.train_scan_launch.restype = ctypes.c_int
    lib = build_lib(build, src, "current")
    lib.train_scan_launch_profiled.argtypes = CURRENT_ARGS
    lib.train_scan_launch_profiled.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def run_earlier(state, batch):
        build.check(earlier.train_scan_launch(
            *[t.data_ptr() for t in state + batch], B, K, L, D, aid, 1.0,
            stream()), "earlier train_scan launch")

    def runner(ring=tc.SCAN_RING, producers=tc.SCAN_PRODUCERS, prof=None):
        mode, depth = tc.scan_plan(L, K, True, ring)

        def run(state, batch):
            build.check(lib.train_scan_launch_profiled(
                *[t.data_ptr() for t in state + batch], B, K, L, D, aid,
                1.0, mode, depth, min(producers, depth), stream(),
                None if prof is None else prof.data_ptr()),
                "current train_scan launch")
        return run

    inputs = {
        "random_columns": lambda: smoke.scan_inputs(torch, np, dev, B, 2),
        "shared_column": lambda: smoke.shared_column_inputs(
            torch, np, dev, B, L, K, D),
    }

    def timed(fn, make, reps=3):
        state, batch = make()
        return smoke.time_cuda(torch, lambda: fn(state, batch), reps)

    def stages(make, ring, producers):
        prof = torch.zeros(16, dtype=torch.int64, device=dev)
        state, batch = make()
        runner(ring, producers, prof)(state, batch)
        p = prof.cpu().tolist()
        return {"ring": ring, "producers": producers,
                "consumer_cycles_per_datum": {
                    k: v / B for k, v in zip(CONSUMER, p[:6])},
                "producer_cycles_per_datum": {
                    k: v / B for k, v in zip(PRODUCER, p[8:11])},
                "writeback_cycles_per_datum": {
                    k: v / B for k, v in zip(WRITEBACK, p[12:14])}}

    result = {"card": card, "shape": [B, K, L, D], "method": "AROW",
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
