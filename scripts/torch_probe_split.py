#!/usr/bin/env python3
"""Time K6 and K7 (jubatus_tpu_torch/csrc/candidates.cu sig_probe and
ivf_probe) of an earlier checkout against the current ones on one CUDA
card, in turns (earlier, current, current, earlier), beside the full
sweeps they prune (K3 sig_topk, K4 dense_topk) and torch.topk over the
candidate width, and split the current kernels into their stages.

    python3 scripts/torch_probe_split.py --earlier DIR \\
        [--ivf-rows N [N ...]] [--out FILE]

DIR is the root of another checkout (for example a `git archive` of an
earlier commit unpacked under build/, which .gitignore lists) whose
csrc/candidates.cu has the entry points sig_probe_launch and
ivf_probe_launch with the current signatures; it is built with the
current flags (kernels/build.py load_variant) and called with the
workspace it asks for: its own *_workspace_bytes where it exports them,
else the one-block kernels' rule (pow2(width) int64 keys a query where
they pass 128 KB of shared memory).  The split: the current source built
twice more, with -DPROBE_UPTO=2 (K7's embedding, centroids and pick) and
with -DPROBE_UPTO=3 -DPROBE_NO_SELECT (up to stage 1's gather and
rescore, no select); `centroid_ms` is the first, `rescore_ms` the second
less the first, `select_ms` the whole less the second (K6 has no
centroid stage).

Tables (bench.py:1240-1313's generators, built on the host without a
driver): lsh H 64 at 10^6 rows of 4096 random prototype signatures, one
bit flipped a row, under lsh_probe at 4 probes (index/lsh_probe.py);
inverted_index rows of Kr 32 over 4096 columns, 250,000 rows (or each
--ivf-rows) of 4096 prototypes of 16 columns, values jittered by 0.05,
under ivf at 4 probes (index/ivf.py), its host build (k-means and
assignment, `rebuild_from`) timed as `build_s`.  The queries are stored
rows (K6 by row, K7 a row's own features; K6 also 64 rows a call, the
batch route's shape, `device_ms_64`, with torch.topk over [64, width] as
`topk_ms_64`).  `bound_ms` (and K6's `bound_ms_64`) are the least times
of this run's data by class (chip_smoke.probe_bound, ivf_bound: the
probed groups' ids up to the cap, the delta, the valid candidates' rows,
the results).  `*_ms` are device ms: 10
calls captured in a CUDA graph and replayed between CUDA events
(chip_smoke.time_device).  Each kernel's result is checked bitwise
against its plain version and the earlier kernel's.  Prints one
`probe_split {...}` JSON line with the card's name and power limit and
writes it to FILE when given; exits 1 if a result differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NN_ROWS = 10 ** 6
IVF_ROWS = 250_000        # chip_smoke.py INDEX_IVF_ROWS
PROTOS = 4096
PROBES = 4
K = 10
EARLIER_SMEM_KEYS = 128 * 1024   # the one-block kernels' shared keys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True,
                    help="root of the checkout holding the earlier kernels")
    ap.add_argument("--ivf-rows", type=int, nargs="+", default=[IVF_ROWS],
                    help="rows of K7's tables (default %(default)s)")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from jubatus_tpu_torch.index import IndexSpec, IvfIndex, SigProbeIndex
    from jubatus_tpu_torch.kernels import build
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L

    if not torch.cuda.is_available():
        print("torch_probe_split: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cur_src = build.SRC_DIR / "candidates.cu"
    old_src = os.path.join(args.earlier, "jubatus_tpu_torch", "csrc",
                           "candidates.cu")
    base = build.flags("candidates")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = {
            "current": pool.submit(C._lib),
            "earlier": pool.submit(build.load_variant, "candidates",
                                   old_src, "earlier"),
            "upto2": pool.submit(build.load_variant, "candidates", cur_src,
                                 "upto2", base + ("-DPROBE_UPTO=2",)),
            "upto3": pool.submit(build.load_variant, "candidates", cur_src,
                                 "upto3ns", base + ("-DPROBE_UPTO=3",
                                                    "-DPROBE_NO_SELECT")),
        }
        libs = {k: v.result() for k, v in jobs.items()}
    build_s = time.perf_counter() - t0
    for k in ("upto2", "upto3"):
        C.bind(libs[k])
    old = libs["earlier"]
    old.sig_probe_launch.argtypes = C._lib().sig_probe_launch.argtypes
    old.sig_probe_launch.restype = ctypes.c_int
    old.ivf_probe_launch.argtypes = C._lib().ivf_probe_launch.argtypes
    old.ivf_probe_launch.restype = ctypes.c_int
    try:
        C.bind(old)
        old_ws = None
    except AttributeError:       # the one-block kernels: no export
        def old_ws(nq, keys):
            if keys * 8 <= EARLIER_SMEM_KEYS:
                return 0, None
            t = torch.empty((nq, keys), dtype=torch.int64, device=dev)
            return t.data_ptr(), t

    def graph_ms(fn):
        ms, how = smoke.time_device(torch, fn, 10)
        if ms is None:
            raise RuntimeError(f"torch_probe_split: no device time: {how}")
        return ms

    whole = C._lib()

    def with_lib(lib, fn):
        def run():
            C._lib = lambda: lib
            try:
                return fn()
            finally:
                C._lib = lambda: whole
        return run

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def ab(current, earlier):
        ms = {"earlier": [], "current": []}
        for who in ("earlier", "current", "current", "earlier"):
            ms[who].append(graph_ms(current if who == "current"
                                    else earlier))
        return ms

    def split(fn, centroids):
        t = {k: [graph_ms(with_lib(libs[k], fn)) for _ in range(2)]
             for k in ("upto2", "upto3")}
        t["whole"] = [graph_ms(fn) for _ in range(2)]
        m = {k: min(v) for k, v in t.items()}
        out = {"stages_ms": t, "rescore_ms": m["upto3"]
               - (m["upto2"] if centroids else 0.0),
               "select_ms": m["whole"] - m["upto3"]}
        if centroids:
            out["centroid_ms"] = m["upto2"]
        return out

    equal = True
    rng = np.random.default_rng(17)
    # K6: lsh H 64 at 10^6 rows
    protos = rng.integers(0, 2 ** 32, (PROTOS, 2), dtype=np.uint32)
    sigs = protos[rng.integers(0, PROTOS, NN_ROWS)]
    sigs[np.arange(NN_ROWS), rng.integers(0, 2, NN_ROWS)] ^= \
        np.uint32(1) << rng.integers(0, 32, NN_ROWS, dtype=np.uint32)
    six = SigProbeIndex("lsh", 64, IndexSpec(kind="lsh_probe",
                                             probes=PROBES), put=put)
    six.rebuild_from({0: (np.arange(NN_ROWS), sigs)})
    csr = six.device_csr()
    table = put(sigs.view(np.int32))
    norms = put(np.ones(NN_ROWS, np.float32))
    kb = C._kb(K, six.plan, csr[4], csr[3])
    width = C._cand_width(six.plan, csr[4], csr[3])
    q_rows = torch.tensor([12345], device=dev)
    sargs = ("lsh", table, norms, NN_ROWS, None, csr, six.plan, six.bits,
             64, kb)
    pl = C._plan_dev(tuple(six.plan), dev)
    tab = L._count_table_dev("lsh", 64, dev)

    def k6(rows=q_rows):
        return C.sig_probe(*sargs, q_rows=rows)

    def k6_old(rows=q_rows):
        nq = rows.shape[0]
        out = torch.empty((nq, 2 * kb + 1), dtype=torch.int64, device=dev)
        npad = C._pow2(width)
        if old_ws is None:
            ws = C._workspace(old.sig_probe_workspace_bytes(
                width, len(six.plan), kb, nq), dev)
            wp = ws.data_ptr()
        else:
            wp, ws = old_ws(nq, npad)
        flat, off, ln, dl, cap = csr
        err = old.sig_probe_launch(
            table.data_ptr(), norms.data_ptr(), NN_ROWS, 2, NN_ROWS, 0, 0,
            0, rows.data_ptr(), nq, flat.data_ptr(), flat.shape[0],
            off.data_ptr(), ln.data_ptr(), dl.data_ptr(), dl.shape[0],
            pl.data_ptr(), len(six.plan), six.bits, cap, 0, tab.data_ptr(),
            kb, npad, wp, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "earlier sig_probe launch")
        return out

    ref = C.sig_probe_ref("lsh", table, norms, NN_ROWS, None, table[q_rows],
                          norms[q_rows], *csr[:4], csr[4], six.plan,
                          six.bits, 64, kb)
    same = torch.equal(k6(), ref) and torch.equal(k6_old(), ref)
    # the batch route's shape: 64 stored rows a call
    q64 = torch.from_numpy(rng.integers(0, NN_ROWS, 64)).to(dev)
    ref64 = C.sig_probe_ref("lsh", table, norms, NN_ROWS, None, table[q64],
                            norms[q64], *csr[:4], csr[4], six.plan,
                            six.bits, 64, kb)
    same &= torch.equal(k6(q64), ref64) and torch.equal(k6_old(q64), ref64)
    equal &= same
    scores = torch.from_numpy(rng.random((1, width), dtype=np.float32)
                              ).to(dev)
    scores64 = torch.from_numpy(rng.random((64, width), dtype=np.float32)
                                ).to(dev)
    # the bounds of this run's data (chip_smoke.probe_bound): a query's
    # probed groups' ids read up to the cap, the delta, its valid
    # candidates
    groups = C.probe_groups_ref("lsh", table[q_rows], six.plan, six.bits)
    groups64 = C.probe_groups_ref("lsh", table[q64], six.plan, six.bits)
    slots64 = sum(smoke.cand_slots(csr, g) for g in groups64)
    k6_row = {"rows": NN_ROWS, "cap": int(csr[4]), "kb": kb, "width": width,
              "n_cand": int(ref[0, 2 * kb]), "equal": same,
              "bound_ms": smoke.probe_bound(
                  "lsh", 2, smoke.cand_slots(csr, groups[0]),
                  int(ref[0, 2 * kb]), 1, kb),
              "bound_ms_64": smoke.probe_bound(
                  "lsh", 2, slots64, int(ref64[:, 2 * kb].sum()), 64, kb),
              "topk_ms_64": graph_ms(lambda: torch.topk(scores64, kb)),
              "device_ms": ab(k6, k6_old), "split": split(k6, False),
              "device_ms_64": ab(lambda: k6(q64), lambda: k6_old(q64)),
              "full_sweep_ms": graph_ms(lambda: L.sig_topk(
                  "lsh", table, norms, NN_ROWS, q_rows=q_rows, hash_num=64,
                  kb=smoke.NN_KB)),
              "topk_ms": graph_ms(lambda: torch.topk(scores, kb))}
    print(f"probe_split: K6 {k6_row}", flush=True)
    del table, norms, sigs, six, csr
    torch.cuda.empty_cache()
    k7_rows = []
    for ivf_rows in args.ivf_rows:
        cl_idx = np.stack([rng.choice(4096, 16, replace=False)
                           for _ in range(PROTOS)]).astype(np.int32)
        cl_val = rng.standard_normal((PROTOS, 16)).astype(np.float32)
        asn = rng.integers(0, PROTOS, ivf_rows)
        idx = np.zeros((ivf_rows, 32), np.int32)
        val = np.zeros((ivf_rows, 32), np.float32)
        idx[:, :16] = cl_idx[asn]
        val[:, :16] = cl_val[asn] + 0.05 * rng.standard_normal(
            (ivf_rows, 16)).astype(np.float32)
        rnorms = np.sqrt((val * val).sum(1)).astype(np.float32)
        ivf = IvfIndex("cosine", IndexSpec(kind="ivf", probes=PROBES),
                       put=put)
        t0 = time.perf_counter()
        ivf.rebuild_from(np.arange(ivf_rows), idx, val)
        ivf_build_s = time.perf_counter() - t0
        csr = ivf.device_csr()
        cent = ivf.device_centroids()
        ti, tv, tn = put(idx), put(val), put(rnorms)
        q = 777
        qi, qv = put(idx[q, :16]), put(val[q, :16])
        qd = torch.zeros(4096, dtype=torch.float32, device=dev)
        qd[qi.long()] = qv
        qn = float(rnorms[q])
        probes = min(PROBES, cent.shape[0])
        c = int(cent.shape[0])
        kb7 = C._ivf_kb(K, probes, csr[4], csr[3])
        width7 = 2 * probes * int(csr[4]) + int(csr[3].shape[0])
        iargs = ("cosine", qi, qv, qd, qn, cent, ti, tv, tn, ivf_rows, None,
                 csr, probes, 64, kb7)

        def k7(iargs=iargs):
            return C.ivf_probe(*iargs)

        def k7_old(kb7=kb7, width7=width7, csr=csr, cent=cent, qi=qi, qv=qv,
                   qd=qd, qn=qn, ti=ti, tv=tv, tn=tn, probes=probes, c=c,
                   ivf_rows=ivf_rows):
            out = torch.empty((1, 2 * kb7 + 1), dtype=torch.int64,
                              device=dev)
            npad, cpad = C._pow2(width7), C._pow2(c)
            if old_ws is None:
                ws = C._workspace(old.ivf_probe_workspace_bytes(
                    width7, probes, kb7, c, 64), dev)
                wp = ws.data_ptr()
            else:
                wp, ws = old_ws(1, max(npad, cpad))
            flat, off, ln, dl, cap = csr
            err = old.ivf_probe_launch(
                qi.data_ptr(), qv.data_ptr(), qi.shape[0], qd.data_ptr(),
                float(np.float32(qn)), cent.data_ptr(), c, 64, probes,
                ti.data_ptr(), tv.data_ptr(), tn.data_ptr(), ivf_rows, 32,
                ivf_rows, 0, flat.data_ptr(), flat.shape[0], off.data_ptr(),
                ln.data_ptr(), dl.data_ptr(), dl.shape[0], cap, 0, kb7, npad,
                cpad, wp, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            build.check(err, "earlier ivf_probe launch")
            return out

        ref = C.ivf_probe_ref("cosine", qi, qv, qd, torch.tensor(
            np.float32(qn), device=dev), cent, ti, tv, tn, ivf_rows, None,
            *csr[:4], csr[4], probes, 64, kb7)
        same = torch.equal(k7(), ref) and torch.equal(k7_old(), ref)
        equal &= same
        qd_t = qd[None]
        qn_t = torch.tensor([qn], dtype=torch.float32, device=dev)
        scores = torch.from_numpy(rng.random((1, width7), dtype=np.float32)
                                  ).to(dev)
        e_q = C.cs_embed_ref(qi, qv, 64)
        top = torch.topk(L.scores_to_keys(C.centroid_scores_ref(cent, e_q)),
                         probes).values
        top_c = L.MASK32 - (top & L.MASK32)
        slots7 = smoke.cand_slots(csr, torch.cat([top_c, top_c + c]))
        row = {"rows": ivf_rows, "build_s": ivf_build_s, "centroids": c,
               "cap": int(csr[4]), "kb": kb7, "width": width7,
               "n_cand": int(ref[0, 2 * kb7]), "equal": same,
               "bound_ms": smoke.ivf_bound(c, 64, qi.shape[0], 4096, 32,
                                           slots7, int(ref[0, 2 * kb7]),
                                           kb7),
               "device_ms": ab(k7, k7_old), "split": split(k7, True),
               "full_sweep_ms": graph_ms(lambda: L.dense_topk(
                   "cosine", ti, tv, tn, ivf_rows, None, qd_t, qn_t,
                   L._kb(K, ivf_rows))),
               "topk_ms": graph_ms(lambda: torch.topk(scores, kb7))}
        print(f"probe_split: K7 {row}", flush=True)
        k7_rows.append(row)
        del ivf, csr, cent, ti, tv, tn
        torch.cuda.empty_cache()
    result = {"card": card, "torch": torch.__version__, "equal": equal,
              "build_s": build_s, "sig_probe": k6_row, "ivf_probe": k7_rows}
    line = "probe_split " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
