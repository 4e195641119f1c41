#!/usr/bin/env python3
"""Time one spilled read's split on the card, in turns against the
resident route: the A/B tool a later redesign of the streamed sweep
(jubatus_tpu_torch/ops/paged.py) is held against.

    python3 scripts/torch_spill_split.py --out chiprun_out/spill_split.json

Two cells of chip_smoke.py phase 13: (b) nearest_neighbor lsh H 64 at
10^6 rows, page_rows 128, resident_pages 1,953; (c) the recommender's
inverted_index (Kr 32, 4,096 columns) at 250,000 rows, resident_pages
488.  For each, a spilled driver and its resident twin hold the same
table; each turn times `--reads` reads on the spilled driver, then on the
twin (host clock, each read to its answer), and splits `--reads` spilled
sweeps by stage (CUDA events: the pool sweep, the chunks' copies, the
chunks' sweeps, the scores' copy back; the host top-k on the host clock).
Beside them: the bytes streamed a read and the rate the chunks' copies
reach, against a plain pinned copy_ of the same bytes.

Then the streamed chunks' two copy paths (ops/paged.py RUN_BYTES_MIN:
each run of absent pages copied straight from the pinned master, or the
chunk gathered into pinned staging first) at a residency of few runs and
of many: the table as filled (the absent pages one run), then after
`--scatter` counts of pages, cumulative, faulted in at random by
re-writing one row of each with its own bytes (the residency that
updates and the clock leave).  At each residency, in turns, `--reads`
reads by each path (RUN_BYTES_MIN forced either way) and by the rule
(RUN_BYTES_MIN as shipped), with the runs a chunk, the path the rule
picks for each chunk, and the split.  Every spilled answer must equal the twin's,
tie-aware (exit 1 otherwise).  Prints and writes one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def build_cells(torch, np, cs, which):
    """(name, spilled driver, twin, reads) for the cells asked for."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    out = []
    if "b" in which:
        rows, budget = cs.SPILL_NN_CELLS[1][1:]
        cfg = dict(cs.NN_CONFIG, pages={"page_rows": cs.SPILL_PAGE_ROWS,
                                        "resident_pages": budget})
        spill = create_driver("nearest_neighbor", cfg)
        twin = create_driver("nearest_neighbor", cs.NN_CONFIG)
        rng = np.random.default_rng(rows)
        sigs = rng.integers(0, 2 ** 32, (rows, 2), dtype=np.uint64) \
            .astype(np.uint32)
        ids = [f"s{i}" for i in range(rows)]
        for d in (spill, twin):
            d.pages.write(d._rows(ids), {"sig": sigs,
                                         "norms": np.ones(rows, np.float32)})
        qs = cs.nn_datums(np, rng, 64)
        reads = [lambda d, q=q: d.similar_row_from_datum(
            cs.nn_datum(Datum, q), cs.NN_SIZE) for q in qs]
        q_sig = spill.pages.read("sig", [0])

        def sweep(t, spill=spill, q_sig=q_sig):
            from jubatus_tpu_torch.ops import paged as P
            return P.sig_scores(spill.pages, "lsh", 64, q_sig, [1.0],
                                timing=t)[0]
        out.append(("b", spill, twin, reads, sweep, 0.0))
    if "c" in which:
        rng = np.random.default_rng(91)
        cfg = dict(cs.IVF_CONFIG, pages={
            "page_rows": cs.SPILL_PAGE_ROWS,
            "resident_pages": cs.SPILL_RECO_BUDGET})
        spill = create_driver("recommender", cfg)
        twin = create_driver("recommender", cs.IVF_CONFIG)
        protos = [d for d in cs.nn_datums(np, rng, 2 * cs.INDEX_PROTOS)
                  if len(spill.converter.convert_row(cs.nn_datum(Datum, d)))
                  == cs.NN_NNZ][:cs.INDEX_PROTOS]
        rows = cs.ivf_rows(np, rng, spill, cs.SPILL_RECO_ROWS, protos)
        ids = list(rows)
        for d in (spill, twin):
            slots = d.pages.alloc_seq(len(ids)).tolist()
            d.ids = dict(zip(ids, slots))
            d.row_ids = list(ids)
            d.rows = dict(rows)
            d._dirty = dict.fromkeys(ids, True)
            d._sync()
        q_ids = [ids[i] for i in rng.integers(0, len(ids), 64)]
        reads = [lambda d, i=i: d.similar_row_from_id(i, cs.NN_SIZE)
                 for i in q_ids]
        qd, qn = spill._query_row(spill.rows[q_ids[0]])

        def sweep(t, spill=spill, qd=qd, qn=qn):
            from jubatus_tpu_torch.ops import paged as P
            return P.dense_scores(spill.pages, "cosine", qd, qn, timing=t)
        out.append(("c", spill, twin, reads, sweep, 1e-6))
    return out


# the columns each cell's sweep streams
STREAMED = {"b": ("sig", "norms"), "c": ("indices", "values")}


def chunk_runs(np, P, store, names):
    """(runs of absent pages, bytes of the columns `names`) of each
    streamed chunk of the store now."""
    absent = np.nonzero((store._page_loc < 0)
                        & (store._page_occ_vec() > 0))[0]
    cp = max(1, P.SPILL_CHUNK_ROWS // store.page_rows)
    row_bytes = sum(int(np.prod(store.column_schema(n)[0] or (1,)))
                    * store.column_schema(n)[1].itemsize
                    for n in names)
    chunks = [absent[c0: c0 + cp] for c0 in range(0, absent.size, cp)]
    return ([int(P._runs(c)[0].size) for c in chunks],
            [int(c.size) * store.page_rows * row_bytes for c in chunks])


def fault_random_pages(np, rng, store, n):
    """Re-write one row of each of n random occupied pages with its own
    bytes: the write faults the pages into the pool (the clock evicts)."""
    occ = np.nonzero(store._page_occ_vec() > 0)[0]
    pages = rng.choice(occ, min(n, occ.size), replace=False)
    slots = []
    for p in pages.tolist():
        rows = np.nonzero(store.mask_host()[p * store.page_rows:
                                            (p + 1) * store.page_rows])[0]
        slots.append(p * store.page_rows + int(rows[0]))
    slots = np.asarray(slots, np.int64)
    store.write(slots, {n_: store.read(n_, slots) for n_ in store._schema})


def copy_paths(torch, np, cs, P, name, spill, twin, reads, sweep, tol,
               levels, turns):
    """The two copy paths timed in turns at each residency level."""
    rng = np.random.default_rng(7)
    keep = P.RUN_BYTES_MIN
    forced = {"runs": 0, "gather": 1 << 62, "rule": keep}
    out, done = [], 0
    try:
        for level in levels:
            fault_random_pages(np, rng, spill.pages, level - done)
            done = level
            runs, nbytes = chunk_runs(np, P, spill.pages, STREAMED[name])
            row = {"faulted_pages": level, "chunks": len(runs),
                   "runs_a_chunk": runs, "chunk_bytes": nbytes,
                   "rule_picks": ["runs" if b >= keep * r else "gather"
                                  for r, b in zip(runs, nbytes)],
                   "read_ms": {}, "split_ms": {}}
            for path, v in forced.items():
                P.RUN_BYTES_MIN = v
                for read in reads[:4]:
                    if not cs.tie_eq(read(spill), read(twin), tol=tol):
                        raise AssertionError(
                            f"cell {name}: a spilled read by the {path} "
                            "path differs from the resident twin's")
                row["read_ms"][path] = []
            for _ in range(turns):
                for path in ("runs", "gather", "rule", "rule", "gather",
                             "runs"):
                    P.RUN_BYTES_MIN = forced[path]
                    torch.cuda.synchronize()
                    lat = cs.timed_reads(np, [lambda r=r: r(spill)
                                              for r in reads])
                    row["read_ms"][path].append(cs.pct(np, lat, 50))
            for path, v in forced.items():
                P.RUN_BYTES_MIN = v
                row["split_ms"][path] = cs.spill_split(
                    torch, np, P, spill.pages, lambda q, t: sweep(t),
                    range(len(reads)), "cuda")
            print(f"torch_spill_split: copy paths {name} {row}", flush=True)
            out.append(row)
    finally:
        P.RUN_BYTES_MIN = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--reads", type=int, default=16)
    ap.add_argument("--cells", default="bc")
    ap.add_argument("--scatter", default="8,64,512,2048",
                    help="pages faulted in at random, cumulative, before "
                    "each copy-path turn after the filled table's")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_spill_split: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from jubatus_tpu_torch.ops import paged as P
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "turns": args.turns, "reads": args.reads,
              "chunk_rows": P.SPILL_CHUNK_ROWS, "cells": {}}
    for name, spill, twin, reads, sweep, tol in build_cells(
            torch, np, cs, args.cells):
        reads = reads[: args.reads]
        for read in reads:
            if not cs.tie_eq(read(spill), read(twin), tol=tol):
                print(f"torch_spill_split: cell {name}: a spilled read "
                      "differs from the resident twin's", file=sys.stderr)
                return 1
        turns = []
        for _ in range(args.turns):
            torch.cuda.synchronize()
            spilled = cs.timed_reads(np, [lambda r=r: r(spill)
                                          for r in reads])
            resident = cs.timed_reads(np, [lambda r=r: r(twin)
                                           for r in reads])
            turns.append({"spilled_p50_ms": cs.pct(np, spilled, 50),
                          "spilled_p99_ms": cs.pct(np, spilled, 99),
                          "resident_p50_ms": cs.pct(np, resident, 50),
                          "resident_p99_ms": cs.pct(np, resident, 99)})
        split = cs.spill_split(torch, np, P, spill.pages,
                               lambda q, t: sweep(t), range(args.reads),
                               "cuda")
        result["cells"][name] = {
            "rows": spill.pages.n_rows,
            "resident_pages": spill.pages.spec.resident_pages,
            "turns": turns, "split_ms": split,
            "device_bytes": spill.pages.device_bytes(),
            "twin_device_bytes": twin.pages.device_bytes()}
        levels = [0] + [int(x) for x in args.scatter.split(",") if x]
        try:
            result["cells"][name]["copy_paths"] = copy_paths(
                torch, np, cs, P, name, spill, twin, reads, sweep, tol,
                levels, max(1, args.turns // 2))
        except AssertionError as e:
            print(f"torch_spill_split: {e}", file=sys.stderr)
            return 1
        del spill, twin
        torch.cuda.empty_cache()
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_spill_split: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
