#!/usr/bin/env python3
"""Time the port's int8 block quantizer pair (jubatus_tpu_torch/csrc/
quantize.cu) against an earlier version of it on one CUDA card.

    python3 scripts/torch_quant_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists); its
jubatus_tpu_torch/csrc/quantize.cu must have the slice-1 C entry points
(quantize_int8_launch / dequantize_int8_launch over a whole [rows, cols]
tile grid, without n).  Both sources are built with the flags of
jubatus_tpu_torch/kernels/build.py.

Every time is the card's alone: launches into preallocated outputs,
captured into a CUDA graph and replayed between CUDA events (chip_smoke's
time_device), with inputs rotating through more than the 50 MB L2.  Two
tile grids: the MIX round's diff tensor ([2560, 512], 80 tiles) and a
whole [32, 2^20] table ([65536, 512], 2048 tiles).  At each, the earlier
and current kernels run in turns (earlier, current, current, earlier),
after a check that both give the same bytes, beside PyTorch's own cast
kernel moving the same bytes (`copy_` of f32 into int8, and of int8 into
f32: what an elementwise pass of this traffic reaches on the card).
Last, the blockwise wire form at the round's [32, 40883] diff tensor:
the earlier wrapper's zeroed staging buffer, copy and launch against the
current single launch, in turns, by the same method.  Prints one
`quant_ab {...}` JSON line (with the card's name and power limit) and
writes it to FILE when given.
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
SHAPES = {"mix_round": (2560, 512), "whole_table": (65536, 512)}
DIFF_SHAPE = (32, 40883)        # the MIX round's w / cov diff tensor
EARLIER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]


def build_lib(build, src: str, label: str) -> ctypes.CDLL:
    """nvcc `src` with the port's flags into the build directory (reused
    when the source is unchanged)."""
    tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libquantize_{label}-{tag}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernels")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_quant_ab: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as smoke
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.parallel import quantized as tq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    earlier = build_lib(build, os.path.join(
        args.earlier, "jubatus_tpu_torch", "csrc", "quantize.cu"), "earlier")
    for fn in (earlier.quantize_int8_launch, earlier.dequantize_int8_launch):
        fn.argtypes = EARLIER_ARGS
        fn.restype = ctypes.c_int
    lib = tq._lib()

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def bound_ms(elems):
        return (5 * elems + 4 * (elems // tq._BLOCK)) \
            / smoke.HBM_BYTES_PER_S * 1e3

    result = {"card": card}
    rng = np.random.default_rng(0)

    def tile_grid(rows, cols):
        """Rotating inputs past the L2 and preallocated outputs."""
        reps = max(2, -(-(64 << 20) // (4 * rows * cols)))
        xs = [torch.from_numpy((rng.standard_normal((rows, cols)) * 1e-2
                                ).astype(np.float32)).to(dev)
              for _ in range(reps)]
        return (xs, [torch.empty((rows, cols), dtype=torch.int8, device=dev)
                     for _ in xs],
                [torch.empty((rows // 32, cols // 512), device=dev)
                 for _ in xs],
                [torch.empty((rows, cols), device=dev) for _ in xs])

    for key, (rows, cols) in SHAPES.items():
        n = rows * cols
        xs, qs, ss, outs = tile_grid(rows, cols)
        it = [0]

        def rot(fn):
            def call():
                i = it[0] = (it[0] + 1) % len(xs)
                fn(i)
            return call

        def q_earlier(i):
            build.check(earlier.quantize_int8_launch(
                xs[i].data_ptr(), qs[i].data_ptr(), ss[i].data_ptr(), rows,
                cols, stream()), "earlier quantize")

        def d_earlier(i):
            build.check(earlier.dequantize_int8_launch(
                qs[i].data_ptr(), ss[i].data_ptr(), outs[i].data_ptr(), rows,
                cols, stream()), "earlier dequantize")

        def q_current(i):
            build.check(lib.quantize_int8_launch(
                xs[i].data_ptr(), qs[i].data_ptr(), ss[i].data_ptr(), rows,
                cols, n, stream()), "quantize")

        def d_current(i):
            build.check(lib.dequantize_int8_launch(
                qs[i].data_ptr(), ss[i].data_ptr(), outs[i].data_ptr(), rows,
                cols, n, stream()), "dequantize")

        # both versions write the same bytes
        q_earlier(0)
        d_earlier(0)
        torch.cuda.synchronize()
        before = (qs[0].clone(), ss[0].clone(), outs[0].clone())
        q_current(0)
        d_current(0)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   zip(before, (qs[0], ss[0], outs[0])))
        if not same:
            raise AssertionError(f"earlier and current quantizer differ at "
                                 f"{[rows, cols]}")
        calls = 20 if 4 * n > (64 << 20) else 200

        def timed(fn):
            return smoke.time_device(torch, rot(fn), calls)[0]

        turns = {
            "quantize_int8": [[who, timed(q_earlier if who == "earlier"
                                          else q_current)]
                              for who in ("earlier", "current", "current",
                                          "earlier")],
            "dequantize_int8": [[who, timed(d_earlier if who == "earlier"
                                            else d_current)]
                                for who in ("earlier", "current", "current",
                                            "earlier")],
        }
        # PyTorch's cast kernel over the same bytes, by the same method
        cast = {"f32_to_int8": timed(lambda i: qs[i].copy_(xs[i])),
                "int8_to_f32": timed(lambda i: outs[i].copy_(qs[i]))}
        result[key] = {"shape": [rows, cols], "bound_ms": bound_ms(n),
                       "turns_ms": turns, "cast_ms": cast,
                       "bytes_equal": same}
        print(f"quant_ab: {key}: turns {turns} cast {cast}", flush=True)
        del xs, qs, ss, outs

    # the wire form at the round's diff tensor: the earlier wrapper's
    # zeroed staging buffer, copy and launch (quantize_blockwise and
    # dequantize_blockwise as they were) against the current single launch
    n = DIFF_SHAPE[0] * DIFF_SHAPE[1]
    nblk = -(-n // tq._BLOCK)
    reps = max(2, -(-(64 << 20) // (4 * n)))
    xs = [torch.from_numpy((rng.standard_normal(DIFF_SHAPE) * 1e-2
                            ).astype(np.float32)).to(dev)
          for _ in range(reps)]
    wire = [tq.quantize_blockwise(x) for x in xs]
    it = [0]

    def rot(fn):
        def call():
            i = it[0] = (it[0] + 1) % len(xs)
            fn(i)
        return call

    def qb_earlier(i):
        padded = torch.zeros(nblk * tq._BLOCK, device=dev)
        padded[:n] = xs[i].reshape(-1)
        q = torch.empty(nblk * tq._BLOCK, dtype=torch.int8, device=dev)
        s = torch.empty(nblk, device=dev)
        build.check(earlier.quantize_int8_launch(
            padded.data_ptr(), q.data_ptr(), s.data_ptr(), nblk * 32, 512,
            stream()), "earlier quantize")

    def db_earlier(i):
        q, s = wire[i]
        padded = torch.zeros(nblk * tq._BLOCK, dtype=torch.int8, device=dev)
        padded[:n] = q
        out = torch.empty(nblk * tq._BLOCK, device=dev)
        build.check(earlier.dequantize_int8_launch(
            padded.data_ptr(), s.data_ptr(), out.data_ptr(), nblk * 32, 512,
            stream()), "earlier dequantize")

    def qb_current(i):
        tq.quantize_blockwise(xs[i])

    def db_current(i):
        tq.dequantize_blockwise(*wire[i], DIFF_SHAPE)

    def timed_wire(fn):
        return smoke.time_device(torch, rot(fn), 200)[0]

    pairs = {"quantize_blockwise": (qb_earlier, qb_current),
             "dequantize_blockwise": (db_earlier, db_current)}
    result["blockwise"] = {
        "shape": list(DIFF_SHAPE),
        "turns_ms": {name: [[who, timed_wire(e if who == "earlier" else c)]
                            for who in ("earlier", "current", "current",
                                        "earlier")]
                     for name, (e, c) in pairs.items()}}
    print(f"quant_ab: blockwise: {result['blockwise']['turns_ms']}",
          flush=True)
    line = "quant_ab " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
