#!/usr/bin/env python3
"""Time an earlier K1 / K2 (the signature kernels of
jubatus_tpu_torch/csrc/lsh.cu: lsh_signature and minhash_signature)
against the current ones on one CUDA card, and check each against its
own plain version.

    python3 scripts/torch_sig_ab.py --earlier DIR [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
jubatus_tpu_torch/csrc/lsh.cu has the entry points
lsh_signature_launch / minhash_signature_launch(idx, val, out, k0, k1,
B, K, H, stream) (the current K1 also takes its summation order before
the stream) and whose jubatus_tpu_torch/ops/lsh.py has the plain
versions lsh_signature_ref / minhash_signature_ref.  The earlier source
is built with the current lsh kernel's flags.  Shapes: B 1, 64 and 1024
datums of K 16 features (random, standard normal values), H 64 and 512.
Each shape and kernel runs in turns (earlier, current, current,
earlier): `device_ms` is 20 launches captured in a CUDA graph and
replayed between CUDA events (the card's time alone), `call_ms` CUDA
events around eager launches through the C entry point (the host's
ctypes call and the launch).  The two designs' plain versions differ
(the earlier one takes the card's log1pf and logf, the current one
XLA's log1p and log and XLA's summation order), so each kernel is held
bitwise against its own.  Prints one `sig_ab {...}` JSON line (with the
card's name and power limit) and writes it to FILE when given; exits 1
if a kernel differs from its plain version anywhere.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
K = 16
SHAPES = [(b, h) for b in (1, 64, 1024) for h in (64, 512)]


def argtypes(order: bool) -> list:
    """A signature entry's ctypes arguments: (idx, val, out, k0, k1, B, K,
    H[, order], stream)."""
    return ([ctypes.c_void_p] * 3 + [ctypes.c_uint32] * 2
            + [ctypes.c_int] * (4 if order else 3) + [ctypes.c_void_p])


def graph_ms(torch, fn, calls=20, replays=5):
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


def events_ms(torch, fn, reps=200):
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


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernels")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import lsh as L

    if not torch.cuda.is_available():
        print("torch_sig_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    pkg = os.path.join(args.earlier, "jubatus_tpu_torch")
    libs = {"earlier": build.load_variant(
        "lsh", os.path.join(pkg, "csrc", "lsh.cu"), "earlier"),
        "current": L._lib()}
    plains = {"earlier": load_module("earlier_lsh",
                                     os.path.join(pkg, "ops", "lsh.py")),
              "current": L}
    for v, lib in libs.items():
        for kind in ("lsh", "minhash"):
            fn = getattr(lib, f"{kind}_signature_launch")
            fn.argtypes = argtypes(v == "current" and kind == "lsh")
            fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    key = L.prng_key(0x1EAF)
    rows, bad = [], []
    for b, h in SHAPES:
        rng = np.random.default_rng(b + h)
        idx = torch.from_numpy(rng.integers(0, 1 << 20, (b, K)).astype(
            np.int32)).to(dev)
        val = torch.from_numpy(rng.standard_normal((b, K)).astype(
            np.float32)).to(dev)
        for kind, width in (("lsh", L.words_for(h)), ("minhash", h)):
            out = {v: torch.empty((b, width), dtype=torch.int32, device=dev)
                   for v in libs}

            def launch(v, kind=kind, out=out):
                # the current stream: a graph's capture stream too
                order = ((L.projection_order(b, K),)
                         if v == "current" and kind == "lsh" else ())
                err = getattr(libs[v], f"{kind}_signature_launch")(
                    idx.data_ptr(), val.data_ptr(), out[v].data_ptr(),
                    key[0], key[1], b, K, h, *order,
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{v} {kind}: CUDA error {err}")

            row = {"kernel": f"{kind}_signature", "shape": [b, K, h]}
            for v in libs:
                launch(v)
                torch.cuda.synchronize()
                ref = getattr(plains[v], f"{kind}_signature_ref")(
                    key, idx, val, h)
                same = bool(torch.equal(out[v], ref))
                row[f"{v}_equals_plain"] = same
                if not same:
                    bad.append(f"{v} {kind} B {b} H {h}")
            for field, timer in (("device_ms", graph_ms),
                                 ("call_ms", events_ms)):
                for v in ("earlier", "current", "current", "earlier"):
                    row.setdefault(f"{v}_{field}", []).append(
                        timer(torch, lambda v=v: launch(v)))
            rows.append(row)
            print(f"sig_ab: {kind} B {b} H {h}: device earlier "
                  f"{row['earlier_device_ms']} current "
                  f"{row['current_device_ms']} ms", file=sys.stderr)
    line = {"card": card, "k": K, "rows": rows, "differ": bad}
    text = json.dumps(line)
    print("sig_ab " + text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
