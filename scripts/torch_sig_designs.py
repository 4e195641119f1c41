#!/usr/bin/env python3
"""Time the two designs of the signature kernels (K1 lsh_signature, K2
minhash_signature in jubatus_tpu_torch/csrc/lsh.cu) at every shape, to
place the launcher's choice between them (`stream_design`), on one CUDA
card.

    python3 scripts/torch_sig_designs.py [--out FILE]

Builds the current lsh.cu twice more, with the build define SIG_DESIGN=1
(the tile design everywhere) and SIG_DESIGN=2 (the stream design
wherever it may run: K1 in k order, K2 everywhere), beside the current
build, which picks.  For K 16 and 64 and H 64 and 512, at B 1 to 4096,
each kernel's device time is 20 launches captured in a CUDA graph and
replayed between CUDA events, twice per build; every
output is held bitwise against the plain version.  Prints one JSON line
a shape and a `sig_designs {...}` line (with the card's name and power
limit), writes it to FILE when given, and exits 1 if any output differs
from the plain version.
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
FORCED = {"tile": 1, "stream": 2}           # SIG_DESIGN in csrc/lsh.cu
SHAPES = [(b, k, h) for k in (16, 64) for h in (64, 512)
          for b in (1, 64, 256, 512, 1024, 4096)
          if k == 16 or b in (1, 64, 1024)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the summary line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import lsh as L
    from torch_sig_ab import argtypes, graph_ms

    if not torch.cuda.is_available():
        print("torch_sig_designs: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = {"current": L._lib()}
    for name, design in FORCED.items():
        libs[name] = build.load_variant(
            "lsh", build.SRC_DIR / "lsh.cu", f"{name}_design",
            build.flags("lsh") + (f"-DSIG_DESIGN={design}",))
    for lib in libs.values():
        for kind in ("lsh", "minhash"):
            fn = getattr(lib, f"{kind}_signature_launch")
            fn.argtypes = argtypes(kind == "lsh")
            fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    key = L.prng_key(0x1EAF)
    rows, bad = [], []
    for b, k, h in SHAPES:
        rng = np.random.default_rng(b + k + h)
        idx = torch.from_numpy(rng.integers(0, 1 << 20, (b, k)).astype(
            np.int32)).to(dev)
        val = torch.from_numpy(rng.standard_normal((b, k)).astype(
            np.float32)).to(dev)
        for kind, width in (("lsh", L.words_for(h)), ("minhash", h)):
            ref = getattr(L, f"{kind}_signature_ref")(key, idx, val, h)
            row = {"kernel": f"{kind}_signature", "shape": [b, k, h]}
            for v, lib in libs.items():
                out = torch.empty((b, width), dtype=torch.int32, device=dev)

                def launch(lib=lib, out=out, kind=kind):
                    order = (L.projection_order(b, k),) if kind == "lsh" \
                        else ()
                    err = getattr(lib, f"{kind}_signature_launch")(
                        idx.data_ptr(), val.data_ptr(), out.data_ptr(),
                        key[0], key[1], b, k, h, *order,
                        torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"{v} {kind}: CUDA error {err}")

                row[f"{v}_device_ms"] = [graph_ms(torch, launch),
                                         graph_ms(torch, launch)]
                if not torch.equal(out, ref):
                    bad.append(f"{v} {kind} {row['shape']}")
            rows.append(row)
            print(json.dumps(row), flush=True)
    line = {"card": card, "rows": rows, "differ": bad}
    text = json.dumps(line)
    print("sig_designs " + text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
