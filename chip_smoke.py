#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jubatus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc
(/usr/local/cuda or PATH) and PyTorch built for CUDA.  It imports nothing
of JAX or of the JAX package.  Phases, each of which fails the run:

  1. card     — nvidia-smi name/power limit, torch device name
  2. build    — nvcc builds every kernel of the port from csrc/, in parallel,
                and cc the native converter (native/)
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the shapes the main path gives it: quantize_int8 /
                dequantize_int8 bitwise (tiled views up to a whole
                [32, 2^20] table, strided tiles, flat runs ending anywhere
                in a block, a block holding a NaN, whose scale must be NaN
                as in the host codec), train_scan within rtol 1e-5 /
                atol 1e-6 (AROW, PA1, CW at B=256; AROW at B=8192; AROW on
                an 8192-datum stream where every datum shares one column,
                the prefetch ring's read-after-write hazard; bitwise at the
                subnormal datums [3e-20, 3e-20] and [1e-39, 1.0] for all
                seven methods, which must not move w); then the scan
                kernel's time at one 8192-datum microbatch beside its plain
                version's, with its µs per datum and ring depth
  4. server   — the classifier server (jubatus_tpu_torch.cli.server, device
                cuda, the bench AROW configuration at hash_max_size 2^20,
                sequential microbatch, default routing: its train frames
                take the native ingest pipeline — C conversion into pinned
                pooled arenas, one copy to the card, the scan kernel on the
                dispatch thread) answers a wire session: one warm train
                request, then 8192-datum train requests over 32 labels
                (each timed, then again under torch.profiler for the
                card's busy share), classify,
                get_labels, save, load; get_status must report fast_path
                True, ingest_pipeline 1, dispatch_mode threaded; the scan
                kernel must have launched; the port must log no warning;
                scores of a small stream must agree with the CPU reference
                driver.  The reuse check, twice: the request frames three
                times over through an IngestPipeline (pool arenas reused
                after the sync fences), one frame a window; then twelve
                times over at the default window, where queued frames fuse
                into windows of up to 16 frames.  Each leaves w, cov and
                counts bitwise equal to train_raw with a synchronize after
                each frame, and every copied arena is pinned.  The
                main_path line splits the warm and each timed request by
                the server's raw-path calls (request_split_ms), and one
                request by stages timed alone: the decoded route's, the C
                converter (native_convert) and the raw step with its copy
                and scan up to a synchronize (raw_dispatch), each also on a
                fresh driver's first window (first_*)
  5. mix      — one blockwise-int8 (v3) MIX round between two drivers on the
                card: replicas bitwise equal afterwards, drift from an f32
                round within the accumulated quantization bound, both
                quantizer kernels launched; a `mix_round` line with the
                round's stage times (f32 wire; v3 with the codec on the
                card; v3 with the codec on the host); then the quantizer
                pair's time at that round's tile grid ([nblk*32, 512]) and
                at a whole [32, 2^20] table ([65536, 512]), beside its
                plain version's and a library yardstick's
                (torch.quantize_per_channel / torch.dequantize, which the
                port never calls): device_ms from wrapper calls captured in
                a CUDA graph (the card's time alone), call_ms from CUDA
                events around eager wrapper calls (the host's pace when it
                is the slower)
  6. regression — the same three paths for the regression service, the
                reference's shipped PA configuration at hash_max_size 2^20:
                the regression scan kernel (csrc/regression_scan.cu) against
                its plain version within rtol 1e-5 / atol 1e-6 (PA, PA1, PA2
                at B=256; PA at B=8192; PA on an 8192-datum stream where
                every datum shares one column; PA1 on an 8192-datum stream
                whose 40 columns recur across block boundaries and in every
                block in flight; PA at K=4096; PA2 at the shipped C =
                3.4e38), two launches bitwise equal, bitwise equal at the
                subnormal datums (w stays 0 where XLA's does), and its time
                at one 8192-datum microbatch with its plan (T, S, P) and its
                cycles a datum by stage; the regression server on
                cuda (a warm train request, then 4 timed 8192-datum
                requests through the ingest pipeline, each split by the
                server's raw-path calls, then again under torch.profiler,
                whose device time is printed without a busy share (it
                undercounts the scan here); estimate against a CPU driver
                fed the same frames; save, clear, load; get_status with the
                scan kernel's launches) and its `regression` line;
                one v3 MIX round between two regression drivers on the card
                (replicas bitwise equal, drift within the quantization
                bound, both quantizer kernels launched)
  7. cluster  — for each service, a cross-process v3 MIX round: the port's
                coordinator and two port servers (device cuda,
                --mix_quantize, a trigger out of reach) as subprocesses, each
                server trained over the wire on its own 8192-datum half, then
                do_mix on one: the replicas bitwise equal to each other and
                to the same round run in this process on two drivers fed the
                same frames through their raw entry (drift from its f32 twin
                within the quantization bound), the classifier's counts the
                exact sum of both halves, a second do_mix changing nothing,
                both quantizer kernels launched in each server process; a
                `cluster_mix` line per service with the round's time, bytes
                and stages (the master's gather, decode, fold, encode and
                scatter; each server's get_diff and put_diff handler).
                Each server journals (--journal, no snapshot timer); after
                a third round server 1 is SIGKILLed and restarted on its
                directory: it must come back bitwise equal to its model
                before the kill, having replayed its three applied v3
                scatters through dequantize_int8 and its train windows
                through the scan kernel in its new process
  8. durable  — for each service, two port servers on cuda, one with
                --journal (fsync batch, an 8 s snapshot timer) and one
                without, get the same four 8192-datum train requests, timed
                in turns; the journaled one's first snapshot is awaited
                after the first two.  SIGKILL, restart on the directory:
                it must restore the snapshot, replay the 2 windows after it
                with no error, launch its scan kernel once per replayed
                window, and hold the model and answer a read bitwise as a
                driver here fed the same frames through its raw entry.  A
                `durable` line: request ms with and without the journal,
                the snapshot's bytes and pack/write/fsync ms, the
                recovery's restore ms, replay ms (per record) and
                boot-to-routable ms
  9. read lane — for each service, two port servers on cuda trained alike,
                one with --read_batch_window_us 200: 32 client threads each
                send 64 one-datum reads (classify / estimate) to each, in
                turns, twice; every lane answer must be bitwise the same
                read sent alone and the lane must fuse (read_batch_size
                mean > 1).  A `read_lane` line: p50/p99 with and without
                the lane, read_batch_size mean/max, and the driver's
                classify_many / estimate_many alone on the card at B 1,
                16, 64 (CUDA events)
 10. nearest_neighbor — (a) the LSH kernels of csrc/lsh.cu against their
                plain versions: the PRNG's fold_in keys, bits and uniforms
                of the plain version bitwise between the card and the CPU;
                lsh_signature and minhash_signature at B 1024, K 16, H 64
                and 512, at B 64, K 16, H 64 (a lane sweep's) and at B 1,
                K 16, H 64 (a set_row's and a datum read's shape),
                bitwise the plain versions' (a differing bit or slot
                fails); sig_topk (the sweep with its top-16
                selection) over 10^6 rows (lsh H 64, euclid_lsh H 512,
                minhash H 64 — a 256 MB table) with 1 and 64 queries, by
                signature and by stored row, its top keys bitwise the plain
                version's (sig_sweep_ref, then torch.topk); each timed
                beside its plain version and its bound (bytes, or the
                operations class by class: integer, popcount, float32,
                special-function, each at its own rate), sig_topk beside
                torch.topk over [Nq, R] float32 scores.  (b) The service: a
                250,000-row lsh table (bench.py's converter, hash_num 64)
                built here through set_row_many, 1024 rows a call, saved in
                the port's model-file format and loaded by two port servers
                (--type nearest_neighbor, one with --read_batch_window_us
                200); 1024 set_row and 256 calls of each of the four reads
                at size 10 over the wire, each bitwise the in-process
                driver's, whose reads launch sig_topk once each and call
                neither torch.topk nor a plain version; 32 client threads
                of one-datum reads on each, every lane answer bitwise the
                read sent alone and the lane fusing; each server's sig_topk
                launches equal to its reads (plain) or its lane sweeps;
                similar_row_from_datum_many at B 1/16/64; sig_topk on a copy
                of the servers' table at a datum and a by-row read, bitwise
                its plain version, and a datum read's device split (K1 at B
                1, sig_topk, the copy out, the whole call).  (c) MIX
                and recovery, for lsh and for minhash at once: per method
                the port's coordinator's cluster of two journaled servers,
                1024 set_row each (4096 before phase 15 came, 2048 before 17), do_mix, both tables bitwise the union
                applied in the master's order, a second do_mix changing
                nothing, server 1 SIGKILLed and recovered bitwise through
                its signature kernel.  Lines `nn_service` and `nn_cluster`
 11. recommender, anomaly, NN classifier — (a) K4 dense_topk over 10^6
                rows (Kr 32, D 4096, a mask with 1% holes, kb 16), K4
                dense_dots at the exact LOF's sweep, a 64-row LOF table
                and 10^6 rows, K5 sig_counts at the LOF table's sweep
                and four kinds at its 16,384 and at 10^6 rows, 1 and
                64 queries, K3
                with a mask over a 10^6-row lsh H 128 table: each
                bitwise its plain version on the same card tensors, K4
                and K5 one launch a call, timed beside it, its library
                yardstick (torch.topk of the scores, torch.sparse.mm of
                the table as CSR, torch.cdist(p=0)) and its bound.  (b)
                The recommender: bench.py's lsh H 128 on a port server,
                8192 update_rows and 64 clear_rows over the wire, 72
                reads bitwise an in-process driver's, each one K3 launch
                (masked) on both; inverted_index at 10^6 rows, 1%
                dropped, 32 reads each one K4 launch, four against the
                plain version.  (c) Anomaly: bench.py's lof over
                euclid_lsh H 64 on a port server, 1,024 adds over the
                wire (the in-process driver's add overlapping each after
                the first 512, which are timed alone) and 64 calc_score
                reads, every score bitwise the driver's, each sweep one
                K5 launch on both; the exact lof through dense_dots,
                bitwise a CPU driver's.  (d) The NN classifier (euclid_lsh
                H 64, k 128) on bench.py's converter: 4 trains of 2048 and
                32 classifies of 8 to a server and an in-process driver,
                bitwise, each classify one K3 launch
 12. index    — the sublinear query index (csrc/candidates.cu K6
                sig_probe and K7 ivf_probe): (a) nearest_neighbor lsh H 64
                at 10^6 rows (bench.py:1240-1258's table: 4096 prototype
                signatures, each row one of them with a bit flipped,
                written in one store write), --index lsh_probe at 4 probes
                built through its lazy rebuild (host seconds printed), 64
                similar_row_from_id and 64 similar_row_from_datum reads,
                one K6 launch each (K1 too for a datum), each read's K6
                result bitwise the plain version on the same card tensors
                and its answer that result's, the tie-aware recall at k 10
                against the full sweep, the candidates a query, K6's ms
                beside K3's full sweep of the table; (b) the recommender's
                inverted_index (bench.py:1287-1313: Kr 32, 4096 columns,
                prototypes of 16 features) at 250,000 rows with --index
                ivf, the same reads through K7 against its plain version
                and K4's full sweep; (c) over the wire, a nearest_neighbor
                server with --index lsh_probe --index_probes 4 and a
                recommender inverted_index server with --index ivf, 9,216
                writes each (above min_rows), 64 reads each bitwise an
                in-process driver's, one K6 (K7) launch a read on both
                sides, and the get_status index keys; (d) anomaly lof over
                euclid_lsh H 64 with "index": {"min_rows": 0}, 1,024 adds,
                64 calc_score reads through K6, bitwise its plain version
 13. spill    — the spill tier (pages.resident_pages > 0: the master on
                the host in pinned memory, a pool of resident pages on the
                card, reads sweeping the pool and streaming the absent
                pages, ops/paged.py): K5's scores mode (sig_scores) at a
                chunk of 65,536 rows, 1 and 64 queries, and at (b)'s
                pool, K4 dense_dots at (c)'s chunk and pool, each bitwise
                its plain version and timed; (a) nearest_neighbor lsh H 64 at
                bench.py:1067-1077's 65,536 rows, page_rows 128,
                resident_pages 128, written through the store, and (b) at
                bench_paged_rows' 10^6 rows, resident_pages 1,953: 64
                similar_row_from_id and 64 similar_row_from_datum reads,
                each tie-aware its resident twin's, every K5 scores launch
                (the pool's and each chunk's) bitwise its plain version;
                (c) the recommender's inverted_index of phase 12b at
                250,000 rows, resident_pages 488, the same through K4
                dense_dots; each with the reads' p50/p99 (host clock), a
                read's split (pool sweep, chunks' copies and sweeps, the
                scores' copy back, host top-k), the bytes streamed and the
                link rate beside a plain pinned copy_ of the same bytes,
                the twin's read ms, device bytes spilled and resident, the
                spill counters (`spill_nn` and `spill_reco` lines); (d)
                anomaly lof over euclid_lsh H 64 with a quarter of its
                pages resident, 512 adds and 64 calc_scores, bitwise a
                CPU driver's; (e) a nearest_neighbor server with a spill
                config, 4,096 set_rows and 64 reads over the wire,
                bitwise an in-process driver's, get_status's page keys and
                spill counters
 14. partition — the partition plane (--routing partition): (a) in
                process on phase 12's tables, 64 stored rows' payloads
                (partition_query_sig, partition_query_fv) read back
                through similar_row_from_sig_partial on the 10^6-row lsh
                H 64 table with lsh_probe (K6 with q_sigs) and with the
                index set aside (K3 with q_sigs), and through
                similar_row_from_fv_partial on the 250,000-row ivf
                recommender (K7) and its full sweep (K4), each equal to
                similar_row_from_id of the same row and to its plain
                version's decoded answer, every launch's result bitwise
                the plain version on the same card tensors; (b) over the
                wire on the card, the port's coordinator, 2 then 3
                nearest_neighbor servers (NN_CONFIG) behind the port's
                proxy (cli/proxy.py --routing partition): 4,096 set_rows
                through it (16,384 before phase 15 came, 8,192 before 16), 64 reads of each of the four read forms at 2
                partitions, a third server's join and the journal-less
                handoff until the partitions are disjoint and sum to the
                total, the reads again at 3; a 2-server recommender
                (bench.py:914-919's inverted_index, 1,024 columns, 16
                entries a row) with 4,096 update_rows and 64 reads of
                each form; every answer equal to the plain version's over
                a full table holding the same rows, scores exact and ids
                tie-aware; (c) anomaly lof over euclid_lsh H 64 in process
                over 2 ring partitions: the merged kNN's ids and distances
                the full table's, one partition's merge bitwise
                calc_score, every K5 launch bitwise its plain version.
                A `partition {...}` line: the reads' p50/p99 through the
                proxy at 2 and 3 partitions, the merge's ms, the
                handoff's rows/s and bytes, the phase's seconds
 15. operating — the operating plane (ROADMAP Queue 1 items 3.3, 3.4),
                its servers subprocesses started at once: (a) the four
                train modes at bench_ingest_pipeline's shape (64 clients x
                25 requests x 4 rows, --thread 64) on the sequential AROW
                config: per-request (--batch_max 1 --batch_window_us 0
                --ingest_depth 0), batched (--ingest_depth 0), pipelined
                (the defaults) and inline (--dispatch inline), each with
                its samples/s, get_status stage totals and train_scan
                launches; then each cleared and trained by one client on
                the same requests in wire order, every model (and a fifth
                server's with the tracer on) bitwise equal; (b) classify
                qps at bench_tracing_overhead's 16 clients x 25 requests
                without and with --trace_ring 4096 --slow_op_ms 10000, in
                turns; (c) a traced two-server --mix_quantize round: the
                applied mix.round span beside the smoke's wall time, its
                mix.get_diff.leg / mix.put_diff.leg records, mix_bytes_*,
                both quantizer kernels launched; (d) a traced
                similar_row_from_datum through the port's proxy at 2
                partitions (2,048 rows), its p50 split into the proxy's
                rpc span, proxy.forward, the members' rpc spans and
                proxy.partition_merge; (e) the exporter's /metrics keys
                equal to get_metrics' (the launch and train counters
                equal), /metrics.json, /traces.json, /livez; (f) a
                --torch_profile server: 8 trains of 1,024 and 32
                classifies, SIGTERM, its Chrome trace naming train_scan,
                the trace's bytes and the trains' ms beside the pipelined
                server's.  Lines `operating_modes {...}` and
                `operating {...}`
 16. tenancy  — many model slots in one server (tenancy/), the smoke's
                AROW config at 2^20 columns (256 MiB of w and cov a slot):
                (a) a --tenant t0 --quota_max_slots 4 server admits m1-m3
                by create_model, each slot trained on its own 16 requests
                of 8,192 datums routed by argument 0 ends bitwise equal
                to a one-slot server fed the same requests and classifies
                alike (each slot's request ms and train_scan launches
                beside the one-slot server's), a fifth slot is refused by
                the cap; (b) a slot with quota.train_rps 50 gets 200
                requests at once, directly and through the port's proxy
                (refused at the edge), the other slots' answers unchanged;
                (e) a slot converting through the simple_splitter C
                plugin ("method": "dynamic", built at first use) trains
                and classifies within rtol 1e-5 / atol 1e-6 of a CPU
                driver; every slot dropped, torch.cuda.memory_allocated()
                back at its value before the creates; (c) two
                --mix_quantize servers with a coordinator, two slots each:
                a do_mix of slot qa leaves its replicas bitwise equal and
                the other slot bitwise unchanged, the quantizer pair
                launched; (d) a journaled two-slot server process
                SIGKILLed and restarted: both slots bitwise, its
                boot-to-routable ms and the replay's scan launches.  A
                `tenancy {...}` line
 17. dp       — the data-parallel tier (parallel/dp.py), the smoke's AROW
                config at 2^20 columns and the shipped PA regression:
                (a) in process, both scans' replica grid (csrc/train_scan.cu,
                csrc/regression_scan.cu) at ndp 1, 4 and 8 on one 8,192-datum
                microbatch, each replica bitwise ndp one-block launches on
                its slice, at ndp 8 integer state bitwise and tables within
                rtol 1e-5 / atol 1e-6 of the plain per-replica loop, the
                grid's ms beside one block over the whole batch (`dp:`
                lines); a DP driver at ndp 8 and 32 labels, its card memory
                against w, cov and their bases, and one fold with payload
                f32 and int8: the int8 ring on quantize.cu bitwise the same
                ring on the plain quantizer pair, 2n quantize and 2(2n - 1)
                dequantize launches (w and cov), its ms and scratch bytes;
                (b) a standalone --dp_replicas 4 classifier (mix_payload
                int8) and regression server, two 8,192-datum requests
                each and the count-triggered collective round after them, get_status's dp_replicas, mix_collective,
                collective_round and bytes, each saved model bitwise an
                in-process DP driver fed the same frames; (c) two
                --mix_quantize --dp_replicas 2 cluster members, one at
                --mix_topk, do_mix until both agree; (d) a journaled
                --dp_replicas 4 server SIGKILLed after a collective round,
                recovered bitwise with its cmix record replayed and
                collective_round resumed.  A `dp_service {...}` line
 18. shard    — key sharding (parallel/sharded.py, sharded_rows.py) at
                4 shards: (a) phase 12a's 10^6-row lsh_probe table into a
                ShardedNearestNeighborDriver through pack() -> unpack()
                (seconds printed), 64 full and 64 indexed reads by id and
                by datum, each 4 K3 (or 4 K6) launches from the counters,
                bitwise the plain per-shard path on the card, the full
                reads equal to the unsharded driver's up to ties, the 4 K3
                launches of a read timed beside one K3 over the whole
                stack and the 4 K6 beside the unsharded K6; (b) a sharded
                recommender loaded from its unsharded twin's 65,536 rows
                and a sharded anomaly beside its twin (1,024 adds), each
                held to the twin; (c) a --shard_devices 4 --journal
                nearest_neighbor server, 2,048 wire set_rows and 64 reads,
                its status keys, SIGKILL and restart (boot to routable
                printed, reads bitwise) beside a plain server booting the
                sharded server's saved model (answers equal up to ties).
                `shard:` lines and a `shard {...}` line
 19. report   — one JSON line {"kernels": [...]} (launch counts from phases
                4 to 18; counters are zeroed just before each path, and a
                server process's start at 0 with its process; each kernel
                must have launched), then the result line {"ok": true,
                "device": {...}} last.

It exits non-zero and prints no result line when CUDA is unavailable or
when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's end-to-end AROW configuration, microbatch left at its
# default ("sequential")
SERVER_CONFIG = {
    "method": "AROW",
    "parameter": {"regularization_weight": 1.0},
    "converter": {
        "string_rules": [{"key": "*", "type": "str", "sample_weight": "bin",
                          "global_weight": "bin"}],
        "num_rules": [{"key": "*", "type": "num"}],
        "hash_max_size": 1 << 20,
    },
}
# the reference's shipped regression config (config/regression/pa.json:
# PA, sensitivity 0.1, regularization_weight 1.0) with bench.py's converter
REG_CONFIG = {
    "method": "PA",
    "parameter": {"sensitivity": 0.1, "regularization_weight": 1.0},
    "converter": SERVER_CONFIG["converter"],
}
SHIPPED_C = 3.4e38      # regularization_weight of the shipped PA config
N_LABELS = 32
REQ_B = 8192            # datums per train request
N_TRAIN_REQS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# keys a kernel row carries beyond the contract's: the scan's per-datum
# time, ring depth and shared-column stream; the quantizer pair's device
# and call times, the library's by both methods, and the whole-table shape;
# the regression scan's plan (T, S, P) and cycles a datum by stage; the
# LSH kernels' other shapes
EXTRA_KEYS = ("us_per_datum", "ring", "shared_column_ms", "device_ms",
              "device_method", "call_ms", "plain_call_ms",
              "library_device_ms", "library_device_method", "library_call_ms",
              "whole_table", "plan", "cycles_per_datum", "bytes_bound_ms",
              "in_band", "design", "variants", "candidates_mean",
              "full_sweep_ms", "recall", "build_s", "cap", "probes",
              "centroids", "datum_ms", "read_ms", "fallbacks", "fold")


def log(*a):
    print(*a, flush=True)


def bench_batch(rng, n, label_offset=0):
    """n wire datums shaped like bench.py's train requests: 8 string
    features w{t%4}=tok{t}, t < 2^16, plus one number, over N_LABELS
    labels (ten_batch: drawn in two calls, features from one table)."""
    return ten_batch(rng, n, label_offset, labels=N_LABELS)


def reg_batch(rng, n):
    """n wire [score, datum] pairs shaped like bench_batch's datums; the
    score is 3x plus or minus 2 by the parity of the first token, plus
    normal noise of 0.1 (drawn in three calls, features from one
    table)."""
    get = feature_table().__getitem__
    toks = rng.integers(0, 1 << 16, size=(n, 8))
    xs = rng.random(n)
    ys = 3.0 * xs + (toks[:, 0] % 2 * 4.0 - 2.0) + rng.normal(0, .1, n)
    return [[y, [list(map(get, row)), [["x", x]], []]]
            for y, row, x in zip(ys.tolist(), toks.tolist(), xs.tolist())]


def time_cuda(torch, fn, reps):
    """Mean ms per call over `reps` calls, by CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_device(torch, fn, calls, replays=3):
    """Device ms per call of `fn`, without the host's work per call:
    `calls` calls (each picks its own inputs) captured into one CUDA graph
    after a warm-up outside it, the graph replayed `replays` times between
    CUDA events.  Where capture fails, torch.profiler's sum of kernel
    times over `calls` eager calls.  Returns (ms, method); (None, reason)
    when neither works."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / (replays * calls), "cuda_graph"
    except Exception as e:  # noqa: BLE001 - the yardstick may not capture
        reason = f"capture failed: {type(e).__name__}: {e}"[:200]
        log(f"time_device: {reason}; timing by torch.profiler")
    torch.cuda.synchronize()
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            us += float(getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0)))
        if us > 0.0:
            return us / 1e3 / calls, "profiler"
        reason += "; the profiler saw no device time"
    except Exception as e:  # noqa: BLE001
        reason += f"; profiler failed: {type(e).__name__}: {e}"[:200]
    return None, reason


def fresh_scan(torch, dev, n_labels, d, batch):
    """A fresh scan state [w, cov, counts, active] and `batch` (numpy
    [indices, values, labels, mask]) on `dev`."""
    state = [torch.zeros((n_labels, d), dtype=torch.float32, device=dev),
             torch.ones((n_labels, d), dtype=torch.float32, device=dev),
             torch.zeros(n_labels, dtype=torch.int32, device=dev),
             torch.zeros(n_labels, dtype=torch.bool, device=dev)]
    return state, [torch.from_numpy(a).to(dev) for a in batch]


def scan_inputs(torch, np, dev, b, seed, n_labels=N_LABELS, k=16,
                d=1 << 20):
    """A fresh scan state and a b-datum microbatch with 9 random live
    columns per datum (real column-0 features in the first sixteenth,
    three padding datums at the end), on `dev`."""
    r = np.random.default_rng(seed)
    idx = np.zeros((b, k), np.int32)
    val = np.zeros((b, k), np.float32)
    idx[:, :9] = r.integers(1, d, (b, 9))
    val[:, :9] = r.standard_normal((b, 9)).astype(np.float32)
    idx[: b // 16, 0] = 0       # real features at column 0
    lab = r.integers(0, n_labels, b).astype(np.int32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0
    return fresh_scan(torch, dev, n_labels, d, (idx, val, lab, mask))


SHARED_COL = 12345      # the column every datum of the hazard stream shares


def shared_column_inputs(torch, np, dev, b, n_labels, k, d, seed=5):
    """A bench-shaped microbatch that stresses the scan kernel's
    read-after-write hazard: 8 string columns of value 1 (bin weights),
    one numeric feature at SHARED_COL in every datum, padding (column 0,
    value 0) after; a real column-0 feature in every 16th datum and a
    repeated column in every 8th; the first quarter labelled 0 or 1 only
    (so a datum's label is often the previous datum's rival), then
    labels in turn; a run of padding datums and a run of not-ok datums
    (all values 0).  Returns fresh_scan's state and batch."""
    r = np.random.default_rng(seed)
    idx = np.zeros((b, k), np.int32)
    val = np.zeros((b, k), np.float32)
    idx[:, :8] = r.integers(1, d, (b, 8))
    val[:, :8] = 1.0
    idx[:, 8] = SHARED_COL
    val[:, 8] = r.random(b).astype(np.float32)
    idx[::16, 0] = 0
    idx[::8, 5] = idx[::8, 4]
    lab = (np.arange(b) % n_labels).astype(np.int32)
    lab[: b // 4] = r.integers(0, 2, b // 4)
    mask = np.ones(b, np.float32)
    mask[100:103] = 0.0
    val[200:203] = 0.0
    return fresh_scan(torch, dev, n_labels, d, (idx, val, lab, mask))


class WireClient:
    """msgpack-RPC over one TCP connection (new-spec requests, like
    bench.py's client)."""

    def __init__(self, port, name=""):
        import msgpack
        self._msgpack = msgpack
        self.name = name            # the cluster name, every call's arg 0
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        # binary answered as the old spec's raw (a signature's bytes)
        # decodes with surrogate escapes and is sent back as the bytes
        self.unpacker = msgpack.Unpacker(raw=False, strict_map_key=False,
                                         unicode_errors="surrogateescape",
                                         max_buffer_size=1 << 30)
        self.msgid = 0

    def frame(self, method, *args) -> bytes:
        self.msgid += 1
        return self._msgpack.packb([0, self.msgid, method,
                                    [self.name, *args]], use_bin_type=True,
                                   unicode_errors="surrogateescape")

    def send(self, frame: bytes, method: str = "?"):
        """Send one pre-encoded request and return its result.  The msgid
        is read from the frame's head alone: decoding a whole 1 MB train
        frame would put tens of ms of the client's own work in the
        request's time."""
        head = self._msgpack.Unpacker()
        head.feed(frame[:16])
        head.read_array_header()
        head.unpack()                       # the message type
        msgid = head.unpack()
        self.sock.sendall(frame)
        while True:
            for msg in self.unpacker:
                if msg[2] is not None:
                    raise RuntimeError(f"rpc {method} failed: {msg[2]}")
                if msg[1] != msgid:
                    raise RuntimeError(f"rpc {method}: msgid mismatch")
                return msg[3]
            data = self.sock.recv(1 << 20)
            if not data:
                raise RuntimeError("server closed the connection")
            self.unpacker.feed(data)

    def call(self, method, *args):
        return self.send(self.frame(method, *args), method)

    def call_bare(self, method, *args):
        """A call without the cluster name (the proxy's own RPCs)."""
        self.msgid += 1
        return self.send(self._msgpack.packb(
            [0, self.msgid, method, list(args)], use_bin_type=True), method)

    def receive(self):
        """The result of the one request sent by hand (sock.sendall of a
        frame)."""
        while True:
            for msg in self.unpacker:
                if msg[2] is not None:
                    raise RuntimeError(f"rpc error: {msg[2]}")
                return msg[3]
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise RuntimeError("connection closed")
            self.unpacker.feed(chunk)

    def close(self):
        self.sock.close()


def phase_kernels(torch, np):
    """Phase 3: every kernel against its plain version, then timings."""
    from jubatus_tpu_torch.models.classifier import (scan_smem_bytes,
                                                     train_scan,
                                                     train_scan_ref)
    from jubatus_tpu_torch.parallel.quantized import (
        _dequantize_ref, _quantize_ref, dequantize_int8, quantize_int8)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = {}

    # -- quantizer: bitwise at [32, 512], [4096, 512] and a full-width
    # diff block through the blockwise view
    def quant_case(x_np):
        x = torch.from_numpy(x_np).to(dev)
        q, s = quantize_int8(x)
        qr, sr = _quantize_ref(x)
        if not (torch.equal(q, qr) and torch.equal(s, sr)):
            raise AssertionError(f"quantize_int8 != plain at {x_np.shape}: "
                                 f"{int((q != qr).sum())} int8 differ")
        d = dequantize_int8(q, s)
        dr = _dequantize_ref(q, s)
        if not torch.equal(d, dr):
            raise AssertionError(f"dequantize_int8 != plain at {x_np.shape}")
        return x, q, s

    def mixed(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        x *= rng.choice(np.array([1e-4, 1.0, 1e3], np.float32), size=shape)
        return x

    small = np.clip(mixed((32, 512)), -100.0, 100.0)
    small[0, :4] = [63.5, -63.5, 0.5, 127.0]   # scale 1: exact ties
    small[1, :4] = np.nextafter(np.float32([63.5, -63.5, 0.5, 2.5]),
                                np.float32(0.0))   # an ulp inside a tie
    quant_case(small)
    mid = mixed((4096, 512))
    mid[32:64] = 0.0                            # an all-zero tile
    quant_case(mid)
    quant_case(mixed((96, 1536)))               # strided tiles (C != 512)
    quant_case(mixed((2560, 512)))              # the MIX round's 80 tiles
    quant_case(mixed((65536, 512)))             # a whole [32, 2^20] table
    from jubatus_tpu_torch.parallel.quantized import (
        dequantize_blockwise, dequantize_blockwise_np, quantize_blockwise,
        quantize_blockwise_np)
    # flat runs that end anywhere in a block, against the host codec
    for n in (1, 15, 16383, 16384, 16385):
        flat = mixed((n,))
        qb, sb = quantize_blockwise(torch.from_numpy(flat).to(dev))
        qn, sn = quantize_blockwise_np(flat)
        back = dequantize_blockwise(qb, sb, (n,))
        if not (np.array_equal(qb.cpu().numpy(), qn)
                and np.array_equal(sb.cpu().numpy(), sn)
                and np.array_equal(back.cpu().numpy(),
                                   dequantize_blockwise_np(qn, sn, (n,)))):
            raise AssertionError(f"blockwise pair != host codec at n={n}")
    # a block holding a NaN gets a NaN scale, as in the host codec; the
    # other blocks stay bitwise (a NaN block's int8 values are undefined
    # in numpy's cast and are not compared)
    nan_run = mixed((3 * 16384 + 100,))
    nan_run[16384 + 77] = np.nan
    qb, sb = quantize_blockwise(torch.from_numpy(nan_run).to(dev))
    qn, sn = quantize_blockwise_np(nan_run)
    sb = sb.cpu().numpy()
    keep = np.ones(nan_run.size, bool)
    keep[16384:2 * 16384] = False
    if not (np.array_equal(np.isnan(sb), np.isnan(sn))
            and np.isnan(sb).tolist() == [False, True, False, False]
            and np.array_equal(sb[~np.isnan(sb)], sn[~np.isnan(sn)])
            and np.array_equal(qb.cpu().numpy()[keep], qn[keep])):
        raise AssertionError("a NaN block: the card's scales or the other "
                             "blocks differ from the host codec")
    # a diff block as the MIX round ships it: 32 labels x ~41k touched
    # columns, so the last 16384-element block is partial
    diff_block = (rng.standard_normal((N_LABELS, 41017)) * 1e-2
                  ).astype(np.float32)
    xb = torch.from_numpy(diff_block).to(dev)
    n = xb.numel()
    qb, sb = quantize_blockwise(xb)
    padded = torch.zeros(-(-n // 16384) * 16384, device=dev)
    padded[:n] = xb.reshape(-1)
    qbr, sbr = _quantize_ref(padded.view(-1, 512))
    if not (torch.equal(qb, qbr.reshape(-1)[:n])
            and torch.equal(sb, sbr.reshape(-1))):
        raise AssertionError("quantize_blockwise != plain at 32x41017")
    back = dequantize_blockwise(qb, sb, xb.shape)
    if not torch.equal(back, _dequantize_ref(qbr, sbr).reshape(-1)[:n]
                       .reshape(xb.shape)):
        raise AssertionError("dequantize_blockwise != plain at 32x41017")
    log("kernels: quantize_int8/dequantize_int8 bitwise equal to plain at "
        "[32,512], [4096,512], [96,1536], [2560,512], [65536,512], "
        "blockwise 32x41017 and n in 1, 15, 16383, 16384, 16385; a NaN "
        "block's scale is NaN as in the host codec")

    # -- train_scan: B=256, K=16, L=32, D=2^20 for AROW, PA1, CW
    L, D, K = N_LABELS, 1 << 20, 16

    scan_err = 0.0
    for method in ("AROW", "PA1", "CW"):
        state, batch = scan_inputs(torch, np, dev, 256, 1)
        ref_state = [t.clone() for t in state]
        train_scan(*state, *batch, method, 1.0)
        train_scan_ref(*ref_state, *batch, method, 1.0)
        torch.cuda.synchronize()
        if not (torch.equal(state[2], ref_state[2])
                and torch.equal(state[3], ref_state[3])):
            raise AssertionError(f"train_scan {method}: counts/active differ")
        for name, a, b in (("w", state[0], ref_state[0]),
                           ("cov", state[1], ref_state[1])):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise AssertionError(
                    f"train_scan {method}: {name} max |diff| "
                    f"{float((a - b).abs().max())} beyond rtol 1e-5 atol 1e-6")
            scan_err = max(scan_err, float((a - b).abs().max()))
        if float(state[0].abs().max()) == 0.0:
            raise AssertionError(f"train_scan {method}: no update happened")
    log(f"kernels: train_scan within rtol 1e-5 atol 1e-6 of plain at "
        f"B=256 K=16 L=32 D=2^20 (AROW, PA1, CW), max |diff| {scan_err:.3g}")

    # float32 subnormals flush as under XLA: |x|^2 of [3e-20, 3e-20] is 0
    # (no update), 1e-39 reads as 0 (its column stays 0); bitwise to plain
    for vals in ([3e-20, 3e-20], [1e-39, 1.0]):
        for method in ("perceptron", "PA", "PA1", "PA2", "CW", "AROW",
                       "NHERD"):
            sub = [torch.zeros((2, 8), dtype=torch.float32, device=dev),
                   torch.ones((2, 8), dtype=torch.float32, device=dev),
                   torch.zeros(2, dtype=torch.int32, device=dev),
                   torch.tensor([False, True], device=dev)]
            sub_ref = [t.clone() for t in sub]
            sub_batch = [
                torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device=dev),
                torch.tensor([vals + [0.0, 0.0]], dtype=torch.float32,
                             device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.float32, device=dev)]
            train_scan(*sub, *sub_batch, method, 1.0)
            train_scan_ref(*sub_ref, *sub_batch, method, 1.0)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(sub, sub_ref)) or \
                    float(sub[0][:, 1].abs().max()) != 0.0:
                raise AssertionError(
                    f"train_scan {method} at the subnormal datum {vals}: "
                    f"kernel w {sub[0][:, :3].tolist()}, plain "
                    f"{sub_ref[0][:, :3].tolist()}")
    log("kernels: train_scan bitwise equal to plain at the subnormal datums "
        "[3e-20, 3e-20] and [1e-39, 1.0], all seven methods")

    # -- timing at the main path's shape: one 8192-datum AROW microbatch
    state, batch = scan_inputs(torch, np, dev, REQ_B, 2)
    before = [t.clone() for t in state[:2]]
    t_ms = time_cuda(torch, lambda: train_scan(*state, *batch, "AROW", 1.0), 5)
    ref_state = [t.clone() for t in before] + [
        torch.zeros(L, dtype=torch.int32, device=dev),
        torch.zeros(L, dtype=torch.bool, device=dev)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_scan_ref(*ref_state, *batch, "AROW", 1.0)
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t0) * 1e3
    # bytes this batch needs: the packed batch once; the w entries of
    # every label at every distinct live column (the scores read them)
    # once; the cov entries the updates change, read once and written
    # once; the w entries they change written once; counts and active
    one = [t.clone() for t in before] + [
        torch.zeros(L, dtype=torch.int32, device=dev),
        torch.zeros(L, dtype=torch.bool, device=dev)]
    train_scan(*one, *batch, "AROW", 1.0)
    torch.cuda.synchronize()
    # the same 8192-datum batch through the kernel once and the plain
    # version once, from the same state: within the per-batch tolerance
    if not (torch.equal(one[2], ref_state[2])
            and torch.equal(one[3], ref_state[3])):
        raise AssertionError("train_scan AROW B=8192: counts/active differ")
    for name, a, b in (("w", one[0], ref_state[0]),
                       ("cov", one[1], ref_state[1])):
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"train_scan AROW B=8192: {name} max |diff| "
                                 f"{err} beyond rtol 1e-5 atol 1e-6")
        scan_err = max(scan_err, err)
    log(f"kernels: train_scan within rtol 1e-5 atol 1e-6 of plain at "
        f"B=8192 (AROW), max |diff| {scan_err:.3g}")
    plan = train_scan.last_plan
    log(f"kernels: train_scan plan at B=8192 K=16 L=32: mode {plan[0]}, "
        f"ring depth {plan[1]}, producer warps {plan[2]}, dynamic shared "
        f"memory {scan_smem_bytes(plan[0], True, plan[1], L, K)} bytes")

    # -- the read-after-write hazard of the prefetch ring at B=8192: every
    # datum carries one shared column (the numeric feature of bench
    # requests) and the padding column 0
    sh_state, sh_batch = shared_column_inputs(torch, np, dev, REQ_B, L, K, D)
    sh_ms = time_cuda(torch, lambda: train_scan(*sh_state, *sh_batch, "AROW",
                                                1.0), 3)
    sh_state, sh_batch = shared_column_inputs(torch, np, dev, REQ_B, L, K, D)
    sh_ref = [t.clone() for t in sh_state]
    train_scan(*sh_state, *sh_batch, "AROW", 1.0)
    train_scan_ref(*sh_ref, *sh_batch, "AROW", 1.0)
    torch.cuda.synchronize()
    if not (torch.equal(sh_state[2], sh_ref[2])
            and torch.equal(sh_state[3], sh_ref[3])):
        raise AssertionError("train_scan shared-column stream: counts/active "
                             "differ")
    for name, a, b in (("w", sh_state[0], sh_ref[0]),
                       ("cov", sh_state[1], sh_ref[1])):
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"train_scan shared-column stream: {name} "
                                 f"max |diff| {err} beyond rtol 1e-5 "
                                 f"atol 1e-6")
        scan_err = max(scan_err, err)
    if float(sh_state[0][:, SHARED_COL].abs().max()) == 0.0:
        raise AssertionError("train_scan shared-column stream: the shared "
                             "column never moved")
    log(f"kernels: train_scan within rtol 1e-5 atol 1e-6 of plain on the "
        f"shared-column stream at B=8192 (AROW), max |diff| {scan_err:.3g}; "
        f"{sh_ms:.4f} ms a launch there")
    live = batch[3] > 0
    ucols = int(torch.unique(batch[0][live]).numel())
    w_written = int((one[0] != before[0]).sum())
    cov_written = int((one[1] != before[1]).sum())
    scan_bytes = (REQ_B * (2 * K + 2) * 4 + 4 * L * ucols
                  + 4 * (w_written + 2 * cov_written) + 2 * L * 5)
    rows["train_scan"] = dict(
        ms=t_ms, plain_ms=t_plain, library_ms=None, max_abs_err=scan_err,
        bound_ms=scan_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=[REQ_B, K, L, D], us_per_datum=t_ms * 1e3 / REQ_B,
        ring=plan[1], shared_column_ms=sh_ms)
    for name, r in rows.items():
        log(f"kernels: {name} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']})")
    return rows


WHOLE_TABLE = (65536, 512)     # one [32, 2^20] f32 table as 32x512 tiles


def time_quantizer_at(torch, np, shape, seed):
    """The quantizer pair at one [rows, 512] tile grid: each kernel's
    wrapper, its plain version and its library yardstick (per-channel
    affine int8 with the block scales: amax + torch.quantize_per_channel
    over [tiles, 16384], and torch.dequantize of its result; the port
    never calls them), each timed by time_device (device_ms) and by CUDA
    events around eager calls (call_ms).  Inputs rotate through enough
    tensors to exceed the 50 MB L2, so each launch reads device memory."""
    from jubatus_tpu_torch.parallel.quantized import (
        _BLOCK, _dequantize_ref, _quantize_ref, dequantize_int8,
        quantize_int8)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    nblk = shape[0] * shape[1] // _BLOCK
    reps = max(2, -(-(64 << 20) // (nblk * _BLOCK * 4)))
    xs = [torch.from_numpy((rng.standard_normal(shape) * 1e-2
                            ).astype(np.float32)).to(dev)
          for _ in range(reps)]
    qs = [quantize_int8(x) for x in xs]
    # the kernels against their plain versions at exactly this shape
    qr, sr = _quantize_ref(xs[0])
    q_err = float(max((qs[0][0].int() - qr.int()).abs().max(),
                      (qs[0][1] - sr).abs().max()))
    d_err = float((dequantize_int8(*qs[0]) - _dequantize_ref(qr, sr)
                   ).abs().max())
    if q_err != 0.0 or d_err != 0.0:
        raise AssertionError(f"quantizer pair != plain at {shape}: max |diff| "
                             f"{q_err} (quantize), {d_err} (dequantize)")
    del qr, sr
    zps = torch.zeros(nblk, dtype=torch.int64, device=dev)

    def lib_quant(i):
        blocks = xs[i].view(nblk, _BLOCK)
        s = blocks.abs().amax(dim=1).clamp_min(1e-30).div(127.0)
        return torch.quantize_per_channel(blocks, s.double(), zps, 0,
                                          torch.qint8)

    qts = [lib_quant(i) for i in range(len(xs))]
    it = [0]

    def rot(fn):
        def call():
            i = it[0] = (it[0] + 1) % len(xs)
            return fn(i)
        return call

    big = nblk * _BLOCK * 4 > (64 << 20)
    calls, plain_calls = (20, 5) if big else (200, 50)
    fns = {
        "quantize_int8": (lambda i: quantize_int8(xs[i]),
                          lambda i: _quantize_ref(xs[i]), lib_quant),
        "dequantize_int8": (lambda i: dequantize_int8(*qs[i]),
                            lambda i: _dequantize_ref(*qs[i]),
                            lambda i: torch.dequantize(qts[i])),
    }
    elems = nblk * _BLOCK
    bound_ms = (elems * 4 + elems + nblk * 4) / HBM_BYTES_PER_S * 1e3
    out = {}
    for name, (kernel, plain, lib) in fns.items():
        r = dict(shape=list(shape), bound_ms=bound_ms, bound_by="bytes",
                 max_abs_err=q_err if name == "quantize_int8" else d_err)
        r["device_ms"], r["device_method"] = time_device(torch, rot(kernel),
                                                         calls)
        r["call_ms"] = time_cuda(torch, rot(kernel), calls)
        r["plain_device_ms"], _ = time_device(torch, rot(plain), plain_calls)
        r["plain_call_ms"] = time_cuda(torch, rot(plain), plain_calls)
        r["library_device_ms"], r["library_device_method"] = time_device(
            torch, rot(lib), plain_calls)
        r["library_call_ms"] = time_cuda(torch, rot(lib), plain_calls)
        if r["device_ms"] is None or r["plain_device_ms"] is None:
            raise AssertionError(f"{name} at {shape}: no device time "
                                 f"(CUDA graph and profiler both failed)")
        out[name] = r
        log(f"kernels: {name} {list(shape)}: device {r['device_ms']:.5f} ms, "
            f"call {r['call_ms']:.5f} ms (plain device "
            f"{r['plain_device_ms']:.5f}, library device "
            f"{r['library_device_ms']} by {r['library_device_method']}, "
            f"library call {r['library_call_ms']:.5f}; bound "
            f"{bound_ms:.5f} ms by bytes)")
    return out


def time_quantizer(torch, np, diff_shape):
    """The quantizer pair's rows of the kernels line: at the main path's
    shape, the [nblk*32, 512] tile grid of the MIX round's [labels,
    columns] diff tensor (ms is the device time there, plain_ms and
    library_ms too, the library's call time where its device time could
    not be taken), and under `whole_table` the same at [65536, 512]."""
    from jubatus_tpu_torch.parallel.quantized import _BLOCK
    nblk = -(-int(np.prod(diff_shape)) // _BLOCK)
    main = time_quantizer_at(torch, np, (nblk * 32, 512), 3)
    whole = time_quantizer_at(torch, np, WHOLE_TABLE, 4)
    rows = {}
    for name, r in main.items():
        lib = r["library_device_ms"]
        rows[name] = dict(
            r, ms=r["device_ms"], plain_ms=r["plain_device_ms"],
            library_ms=lib if lib is not None else r["library_call_ms"],
            whole_table=whole[name])
    return rows


class PortWarnings(logging.Handler):
    """Collects the WARNING (and worse) records of the port's loggers."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def check(self, where):
        bad = [f"[{r.threadName}] {r.name}: {r.getMessage()}"
               for r in self.records]
        if bad:
            raise AssertionError(f"{where}: the port logged warnings: {bad}")


def time_device_busy(torch, run):
    """Device time (kernels and copies, by torch.profiler) inside `run()`,
    beside its wall time on the host clock.  Returns (device_ms, wall_ms),
    device_ms None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) is not None \
                and str(ev.device_type).endswith("CUDA"):
            us += float(getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0)))
    return (us / 1e3 if us > 0 else None), wall_ms


class StageClock:
    """Host-clock times of a server driver's raw-path calls: the arena
    acquire (inside the convert), convert_raw_batch, train_converted_batch
    (copy and launch) and device_sync, each call as (start, end); and of
    the process's garbage collections by generation (gc0..gc2: the
    smoke's client shares the server's process and its objects)."""

    STAGES = ("acquire", "convert", "step", "sync", "gc0", "gc1", "gc2")

    def __init__(self, drv):
        import gc
        self.calls = {k: [] for k in self.STAGES}
        self._gc_start = 0.0
        gc.callbacks.append(self._on_gc)
        drv.arena_pool.acquire = self._wrap(drv.arena_pool.acquire,
                                            "acquire")
        drv.convert_raw_batch = self._wrap(drv.convert_raw_batch, "convert")
        drv.train_converted_batch = self._wrap(drv.train_converted_batch,
                                               "step")
        drv.device_sync = self._wrap(drv.device_sync, "sync")

    def _on_gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._gc_start = now
        else:
            self.calls[f"gc{info['generation']}"].append(
                (self._gc_start, now))

    def close(self):
        import gc
        gc.callbacks.remove(self._on_gc)

    def _wrap(self, fn, stage):
        def timed(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.calls[stage].append((t0, time.perf_counter()))
        return timed

    def split(self, t0, t1):
        """ms of each stage's calls that started in [t0, t1), beside the
        interval's own ms ("request")."""
        out = {"request": (t1 - t0) * 1e3}
        for stage, calls in self.calls.items():
            out[stage] = sum((b - a) * 1e3 for a, b in calls if t0 <= a < t1)
        return out


def reuse_check(torch, frames, rounds=3, fuse=False):
    """The same 8192-datum frames, `rounds` times over, through an
    IngestPipeline on a fresh cuda driver (the arena pool at its default
    size, so arenas are reused once the sync fences release them) and
    through train_raw with a synchronize after each on another: w, cov
    and counts must be bitwise equal.  Every arena the pipeline copied
    must be pinned.  Without `fuse` each window holds one frame; with it
    the frames are queued behind the held model lock, so they fuse into
    windows of many frames (a sequential scan over r1 || r2 is r1's and
    then r2's)."""
    from jubatus_tpu_torch.batching.arenas import pinned_tensor
    from jubatus_tpu_torch.framework.dispatch import IngestPipeline
    from jubatus_tpu_torch.models.classifier import ClassifierDriver
    from jubatus_tpu_torch.utils.rwlock import RWLock

    class Slot:
        def __init__(self, driver):
            self.driver = driver
            self.model_lock = RWLock()
            self.update_count = 0

        def event_model_updated(self):
            self.update_count += 1

    pooled = ClassifierDriver(SERVER_CONFIG, device="cuda")
    pinned = []
    step = pooled.train_converted_batch

    def checked_step(rb):
        host = pinned_tensor(rb.arena)
        pinned.append(host is not None and host.is_pinned())
        return step(rb)

    pooled.train_converted_batch = checked_step
    slot = Slot(pooled)
    pipe = IngestPipeline(slot)
    try:
        if fuse:
            with slot.model_lock.write():       # the dispatch stage waits
                futs = [pipe.submit(m, o) for _ in range(rounds)
                        for m, o in frames]
            ns = [f.result(timeout=600) for f in futs]
        else:                                   # closed loop, as a client
            ns = [pipe.submit(m, o).result(timeout=600)
                  for _ in range(rounds) for m, o in frames]
        if ns != [REQ_B] * len(ns):
            raise AssertionError("reuse check: a window trained a wrong count")
        pipe.flush()
    finally:
        pipe.stop()
    pooled.device_sync()
    hits, misses = pooled.arena_pool.hits, pooled.arena_pool.misses
    ref = ClassifierDriver(SERVER_CONFIG, device="cuda")
    for _ in range(rounds):
        for m, o in frames:
            ref.train_raw(m, o)
            torch.cuda.synchronize()
    if pooled.labels != ref.labels:
        raise AssertionError("reuse check: label rows differ")
    for name in ("w", "cov", "counts"):
        if not torch.equal(getattr(pooled, name), getattr(ref, name)):
            raise AssertionError(f"reuse check: {name} differs from "
                                 f"train_raw + synchronize: an arena was "
                                 f"rewritten before its copy finished?")
    n = rounds * len(frames)
    if pipe.frames != n or len(pinned) != pipe.windows or not all(pinned):
        raise AssertionError(f"reuse check: {pinned.count(False)} of "
                             f"{len(pinned)} copied arenas not pinned")
    if hits + misses != pipe.windows:
        raise AssertionError(f"reuse check: {hits} hits + {misses} misses "
                             f"for {pipe.windows} windows")
    if fuse:
        # windows of different widths take arenas of different size
        # classes, so only the fusion itself is bounded here
        warm = None
        if pipe.windows >= n:
            raise AssertionError("reuse check: no window fused two frames")
    else:
        warm = IngestPipeline.SYNC_EVERY + IngestPipeline.DEPTH + 1
        if hits <= 0 or misses > warm:
            raise AssertionError(f"reuse check: arena pool {hits} hits, "
                                 f"{misses} misses (warm-up bound {warm})")
    log(f"server: reuse check: {n} frames in {pipe.windows} windows through "
        f"pinned pool arenas ({hits} hits, {misses} misses, warm-up bound "
        f"{warm}) leave w, cov, counts bitwise equal to train_raw + "
        f"synchronize")
    return {"frames": n, "windows": pipe.windows, "pool_hits": hits,
            "pool_misses": misses}


def phase_server(torch, np, card):
    """Phase 4: the wire session against the port server on cuda, whose
    train frames take the native raw path (IngestPipeline)."""
    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.framework.server_base import (kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    rng = np.random.default_rng(1)
    reqs = [bench_batch(rng, REQ_B) for _ in range(N_TRAIN_REQS)]
    warm_req = bench_batch(rng, REQ_B)
    query = [d for _, d in reqs[0][:N_LABELS]]
    warnings = PortWarnings()
    logging.getLogger("jubatus_tpu_torch").addHandler(warnings)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "classifier.json")
        with open(cfg_path, "w") as f:
            json.dump(SERVER_CONFIG, f)
        server, rpc = serve(["--type", "classifier", "--configpath", cfg_path,
                             "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                             "--datadir", tmp, "--device", "cuda"])
        try:
            cli = WireClient(server.args.rpc_port)
            # pre-encode outside the timed window, as bench.py's client does
            frames = [cli.frame("train", r) for r in reqs]
            arenas = server.driver.arena_pool
            clock = StageClock(server.driver)
            # warm, outside the timed window: classify's first launches;
            # then one train request (the dispatch thread's first step,
            # label rows interned, the model grown to 32 rows, the first
            # pinned arena) timed alone up to a read that waits for it
            cli.call("classify", query)
            warm_frame = cli.frame("train", warm_req)
            t0 = time.perf_counter()
            cli.send(warm_frame, "train")
            cli.call("get_labels")
            warm_split = clock.split(t0, time.perf_counter())
            reset_kernel_launches()
            marks = []
            t0 = time.perf_counter()
            for frame in frames:
                marks.append(time.perf_counter())
                n = cli.send(frame, "train")
                if n != REQ_B:
                    raise AssertionError(f"train acknowledged {n!r} datums")
            marks.append(time.perf_counter())
            res = cli.call("classify", query)   # reads scores back: a fence
            train_s = time.perf_counter() - t0
            timed_split = [clock.split(a, b)
                           for a, b in zip(marks, marks[1:])]
            clock.close()
            pool = (arenas.hits, arenas.misses)

            # the card's busy share of a request: the same frames again,
            # under torch.profiler
            def again():
                for frame in frames:
                    cli.send(frame, "train")
                cli.call("get_labels")          # a read: waits for the steps

            busy_ms, busy_wall_ms = time_device_busy(torch, again)
            lat = []
            for i in range(20):
                t1 = time.perf_counter()
                cli.call("classify", [query[i % len(query)]])
                lat.append((time.perf_counter() - t1) * 1e3)
            labels = cli.call("get_labels")
            before = cli.call("classify", query)
            saved = cli.call("save", "smoke")
            loaded = cli.call("load", "smoke")
            after = cli.call("classify", query)
            status = cli.call("get_status")
            cli.close()
            counts = kernel_launches()
        finally:
            rpc.stop()
            server.stop()
    logging.getLogger("jubatus_tpu_torch").removeHandler(warnings)
    warnings.check("phase 4 server session")

    sent = 2 * REQ_B * N_TRAIN_REQS + REQ_B
    if sum(labels.values()) != sent or len(labels) != N_LABELS:
        raise AssertionError(f"get_labels sums to {sum(labels.values())} "
                             f"over {len(labels)} labels, sent {sent}")
    if len(res) != len(query) or any(len(r) != N_LABELS for r in res):
        raise AssertionError("classify did not return 32 scored labels")
    scores = np.array([[sc for _, sc in r] for r in res])
    if not np.isfinite(scores).all() or not np.abs(scores).max() > 0:
        raise AssertionError("classify scores not finite and non-zero")
    if after != before:
        raise AssertionError("classify changed across save/load")
    if not (len(saved) == 1 and loaded is True):
        raise AssertionError(f"save/load failed: {saved!r} {loaded!r}")
    (st,) = status.values()
    if int(st["kernel_launches.train_scan"]) <= 0 or counts["train_scan"] <= 0:
        raise AssertionError("the scan kernel never launched on the main path")
    if st["device"].split(":")[0] != "cuda":
        raise AssertionError(f"server ran on {st['device']}")
    if (st["fast_path"], st["ingest_pipeline"], st["dispatch_mode"]) != \
            ("True", "1", "threaded"):
        raise AssertionError(
            f"the server's train path is not the native ingest pipeline: "
            f"fast_path {st['fast_path']}, ingest_pipeline "
            f"{st['ingest_pipeline']}, dispatch_mode {st['dispatch_mode']}")

    # the pinned-arena reuse check, on the request frames as sent
    splitter = native.load()
    wire = [(f, splitter.parse_envelope(f, 0)[4]) for f in frames]
    reuse = {"one_frame_windows": reuse_check(torch, wire),
             "fused_windows": reuse_check(torch, wire, rounds=12,
                                          fuse=True)}
    warnings.check("reuse check")

    # small-input reference: the same 512-datum stream through a driver on
    # the card and the CPU reference driver (plain versions); scores agree
    # within rtol 1e-4 / atol 1e-5 (sums in another order, 512 dependent
    # steps)
    small = reqs[0][:512]
    drv = {d: ClassifierDriver(SERVER_CONFIG, device=d) for d in ("cuda", "cpu")}
    for d in drv.values():
        d.train([(lbl, Datum.from_msgpack(x)) for lbl, x in small])
    qd = [Datum.from_msgpack(x) for x in query]
    got = np.array([[s for _, s in r] for r in drv["cuda"].classify(qd)])
    ref = np.array([[s for _, s in r] for r in drv["cpu"].classify(qd)])
    if not np.allclose(got, ref, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"cuda driver vs cpu reference: max |diff| "
                             f"{np.abs(got - ref).max()}")
    # where one train request's time goes, on a fresh driver on the card:
    # wire datums -> Datum objects, host feature hashing (the converter
    # alone, on its own instance), and the whole driver.train call
    # (labels, hashing, packing, one copy to the card, the scan kernel)
    # up to a synchronize
    from jubatus_tpu_torch.fv import ConverterConfig, DatumToFVConverter
    t0 = time.perf_counter()
    data = [(lbl, Datum.from_msgpack(x)) for lbl, x in reqs[1]]
    parse_ms = (time.perf_counter() - t0) * 1e3
    conv = DatumToFVConverter(ConverterConfig.from_json(
        SERVER_CONFIG["converter"]))
    t0 = time.perf_counter()
    conv.convert_batch([d for _, d in data], update_weights=True)
    convert_ms = (time.perf_counter() - t0) * 1e3
    fresh = ClassifierDriver(SERVER_CONFIG, device="cuda")
    fresh.train(data[:N_LABELS])              # labels interned, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.train(data)
    torch.cuda.synchronize()
    train_call_ms = (time.perf_counter() - t0) * 1e3
    # the raw path's stages for one request: the FrameSplitter framing
    # one whole frame; then, on a fresh driver whose labels are interned
    # and whose pool holds a warm arena, one convert_raw_batch of one
    # frame alone, then train_converted_batch
    # (the copy of the pinned arena to the card and the scan kernel) up to
    # a synchronize
    t0 = time.perf_counter()
    cut = splitter.FrameSplitter()
    cut.feed(frames[1])
    if cut.next()[4] != wire[1][1]:
        raise AssertionError("FrameSplitter: wrong params offset")
    frame_split_ms = (time.perf_counter() - t0) * 1e3
    raw = ClassifierDriver(SERVER_CONFIG, device="cuda")
    t0 = time.perf_counter()
    warm = raw.convert_raw_batch([wire[0]])
    first_convert_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    raw.train_converted_batch(warm)
    torch.cuda.synchronize()
    first_dispatch_ms = (time.perf_counter() - t0) * 1e3
    raw.arena_pool.release(warm.arena)
    t0 = time.perf_counter()
    rb = raw.convert_raw_batch([wire[1]])
    native_convert_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    raw.train_converted_batch(rb)
    torch.cuda.synchronize()
    raw_dispatch_ms = (time.perf_counter() - t0) * 1e3
    train_request_ms = train_s / N_TRAIN_REQS * 1e3
    main = {"samples_per_s": REQ_B * N_TRAIN_REQS / train_s,
            "train_request_ms": train_request_ms,
            "classify_ms_p50": float(np.median(lat)),
            "train_requests": N_TRAIN_REQS, "datums_per_request": REQ_B,
            # each request's time and the server's raw-path calls that
            # started in it; the warm request's up to its get_labels reply
            "request_split_ms": {"warm": warm_split, "timed": timed_split},
            "split_ms": {"wire_to_datum": parse_ms,
                         "convert_alone": convert_ms,
                         "driver_train": train_call_ms,
                         "frame_split": frame_split_ms,
                         "native_convert": native_convert_ms,
                         "raw_dispatch": raw_dispatch_ms,
                         "first_native_convert": first_convert_ms,
                         "first_raw_dispatch": first_dispatch_ms},
            "device_busy_ms": busy_ms, "device_busy_wall_ms": busy_wall_ms,
            "device_busy_share": (busy_ms / busy_wall_ms
                                  if busy_ms is not None else None),
            "arena_pool": {"hits": pool[0], "misses": pool[1],
                           "reuse_check": reuse},
            "card": card}
    log(f"server: {sent} datums in {2 * N_TRAIN_REQS + 1} train requests "
        f"through the ingest pipeline, get_labels sum "
        f"{sum(labels.values())}, "
        f"train_scan launches {counts['train_scan']}, arena pool {pool[0]} "
        f"hits / {pool[1]} misses over the timed requests, cuda-vs-cpu "
        f"scores max |diff| {np.abs(got - ref).max():.3g}")
    log("main_path " + json.dumps(main))
    return counts


def phase_mix(torch, np, card):
    """Phase 5: one v3 MIX round between two drivers on the card, then
    the round's time with the codec on the card beside the same round
    with the codec on the host."""
    from jubatus_tpu_torch.framework.server_base import (kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.mix import codec
    from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
    from jubatus_tpu_torch.models.classifier import ClassifierDriver
    from jubatus_tpu_torch.parallel.quantized import (dequantize_blockwise_np,
                                                      quantize_blockwise_np)

    rng = np.random.default_rng(2)
    halves = [[(lbl, Datum.from_msgpack(d)) for lbl, d in
               bench_batch(rng, REQ_B, label_offset=h)] for h in range(2)]

    def trained():
        drivers = [ClassifierDriver(SERVER_CONFIG, device="cuda")
                   for _ in range(2)]
        for d, half in zip(drivers, halves):
            d.train(half)
        torch.cuda.synchronize()
        return drivers

    def mix_round(drivers, quantize, codec_dev, stats=None):
        """One round on trained drivers: get_diff, encode, the wire's
        msgpack, decode, mix, encode and decode of the merged diff, and
        put_diff on both.  Returns the round's stages in ms on the host
        clock (every stage ends on the host or at a synchronize)."""
        ms = {}
        t0 = time.perf_counter()
        diffs = [d.encode_diff(d.get_diff()) for d in drivers]
        t1 = time.perf_counter()
        wire = [codec.unpackb(codec.packb(encode_wire_diff(
            x, quantize, codec_dev, stats))) for x in diffs]
        t2 = time.perf_counter()
        got = [codec.decode(w, codec_dev) for w in wire]
        t3 = time.perf_counter()
        merged = ClassifierDriver.mix(got[0], got[1])
        t4 = time.perf_counter()
        scatter = codec.unpackb(codec.packb(
            encode_wire_diff(merged, quantize, codec_dev, stats)))
        back = [codec.decode(scatter, codec_dev) for _ in drivers]
        t5 = time.perf_counter()
        for d, x in zip(drivers, back):
            d.put_diff(x)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        ms.update(get_diff=(t1 - t0) * 1e3, encode=(t2 - t1) * 1e3,
                  decode=(t3 - t2) * 1e3, mix=(t4 - t3) * 1e3,
                  scatter_codec=(t5 - t4) * 1e3, put_diff=(t6 - t5) * 1e3,
                  round=(t6 - t0) * 1e3)
        return ms, got[0]["w"].shape, [got[0], got[1], merged]

    def by_label(d, name):
        t = getattr(d, name)
        rows = sorted(d.labels.items())
        return t[[r for _, r in rows]]

    exact = trained()
    f32_ms, _, _ = mix_round(exact, False, "cuda")
    quant = trained()
    reset_kernel_launches()
    stats = {}
    card_ms, shape, tensors = mix_round(quant, True, "cuda", stats)
    counts = kernel_launches()
    for name in ("w", "cov"):
        a, b = by_label(quant[0], name), by_label(quant[1], name)
        if not torch.equal(a, b):
            raise AssertionError(f"v3 round: replicas differ in {name}")
        drift = float((a - by_label(exact[0], name)).abs().max())
        if drift > stats["max_abs_err"]:
            raise AssertionError(f"v3 round: {name} drift {drift} beyond the "
                                 f"bound {stats['max_abs_err']}")
        log(f"mix: {name} replicas bitwise equal; drift from the f32 round "
            f"{drift:.3g} <= bound {stats['max_abs_err']:.3g}")
    if counts["quantize_int8"] <= 0 or counts["dequantize_int8"] <= 0:
        raise AssertionError(f"quantizer kernels not launched: {counts}")
    if quant[0].get_labels() != quant[1].get_labels():
        raise AssertionError("v3 round: label counts differ between replicas")
    log(f"mix: diff block {list(shape)}, wire {stats['wire']} bytes for "
        f"{stats['raw']} f32 bytes, quantize_int8 launches "
        f"{counts['quantize_int8']}, dequantize_int8 launches "
        f"{counts['dequantize_int8']}")
    # the round's merged diff on the v3 wire: the same bytes whether the
    # kernels or the host codec quantize it
    wire_card = codec.packb(encode_wire_diff(tensors[2], True, "cuda"))
    if wire_card != codec.packb(encode_wire_diff(tensors[2], True, "cpu")):
        raise AssertionError("v3 wire bytes of the merged diff differ "
                             "between the card's codec and the host's")
    log(f"mix: the merged diff's {len(wire_card)} wire bytes are the same "
        f"from the card's codec and the host's")

    # the same v3 round with the codec on the host (the quantizer's plain
    # version on the CPU, the JAX package's numpy math), from freshly
    # trained drivers; order host, host, card so neither side runs only
    # first.  Each round must leave its replicas bitwise equal.
    host_runs, card_runs = [], [card_ms]
    for codec_dev in ("cpu", "cpu", "cuda"):
        drivers = trained()
        ms, _, _ = mix_round(drivers, True, codec_dev)
        (host_runs if codec_dev == "cpu" else card_runs).append(ms)
        for name in ("w", "cov"):
            if not torch.equal(by_label(drivers[0], name),
                               by_label(drivers[1], name)):
                raise AssertionError(f"v3 round, codec on {codec_dev}: "
                                     f"replicas differ in {name}")
        del drivers
    # the JAX package's host codec work for this round, in numpy: the
    # blockwise quantizer on each f32 tensor the round encodes (w and cov
    # of both replicas' diffs and of the merged diff), and its inverse on
    # each tensor the round decodes (two replicas' diffs, the merged diff
    # once per replica)
    arrays = [x[n] for x in tensors for n in ("w", "cov")]
    t0 = time.perf_counter()
    enc = [(quantize_blockwise_np(a), a.shape) for a in arrays]
    t1 = time.perf_counter()
    for (q, s), shp in enc[:4] + enc[4:] + enc[4:]:
        dequantize_blockwise_np(q, s, shp)
    t2 = time.perf_counter()
    mix_line = {
        "f32_round_ms": f32_ms,
        "v3_round_codec_on_card_ms": card_runs,
        "v3_round_codec_on_host_ms": host_runs,
        "numpy_codec_ms": {"quantize": (t1 - t0) * 1e3,
                           "dequantize": (t2 - t1) * 1e3},
        "diff_shape": list(shape), "card": card}
    log("mix_round " + json.dumps(mix_line))
    return counts, shape


def reg_scan_inputs(torch, np, dev, b, seed, k=16, d=1 << 20, live=9,
                    shared=False):
    """A small random w [d] and a b-datum regression microbatch on `dev`,
    bench-shaped: live - 1 entries of value 1 at random columns and one
    number x in [0, 1) (at SHARED_COL in every datum when `shared`: the
    read-after-write hazard of the smoke's traffic), padding (column 0,
    value 0) after; a real column-0 feature in every 16th datum, a column
    repeated in every 8th (across 32-entry chunks when live > 33);
    targets 3x +- 2 plus noise; three padding datums at the end."""
    r = np.random.default_rng(seed)
    w = (r.standard_normal(d) * 0.01).astype(np.float32)
    idx = np.zeros((b, k), np.int32)
    val = np.zeros((b, k), np.float32)
    idx[:, :live] = r.integers(1, d, (b, live))
    val[:, :live] = 1.0
    x = r.random(b).astype(np.float32)
    if shared:
        idx[:, live - 1] = SHARED_COL
    val[:, live - 1] = x
    idx[::16, 0] = 0
    idx[::8, live // 2] = idx[::8, 1]
    tgt = (3.0 * x + np.where(r.random(b) < 0.5, 2.0, -2.0)
           + r.normal(0.0, 0.1, b)).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-3:] = 0.0
    return (torch.from_numpy(w).to(dev),
            [torch.from_numpy(a).to(dev) for a in (idx, val, tgt, mask)])


REG_CONSUMER_STAGES = ("wait_block", "forward", "table_reads", "reduction",
                       "step", "group_adds", "syncwarp", "block_commit")
REG_PRODUCER_STAGES = ("wait_free_slot", "hash", "lookup_gather",
                       "per_datum", "commit")


def reg_scan_cycles(torch, dev, w, batch, plan, eps):
    """One PA launch of regression_scan_grid_launch_profiled at one block
    (clock64 sums by stage) from a copy of w: cycles a datum of the
    consumer warp and of the first producer thread.  Not counted as a
    launch of the path."""
    import ctypes
    from jubatus_tpu_torch.models.regression import _scan_lib
    fn = _scan_lib().regression_scan_grid_launch_profiled
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    prof = torch.zeros(24, dtype=torch.int64, device=dev)
    b, k = batch[0].shape
    err = fn(w.clone().data_ptr(), *[t.data_ptr() for t in batch], b, k,
             w.shape[0], 1, 0, 1.0, eps, *plan,
             torch.cuda.current_stream().cuda_stream, prof.data_ptr())
    if err != 0:
        raise AssertionError(f"regression_scan_grid_launch_profiled: CUDA "
                             f"error {err}")
    p = prof.cpu().tolist()
    return {"consumer": {n: v / b for n, v in zip(REG_CONSUMER_STAGES, p)},
            "producer": {n: v / b for n, v in zip(REG_PRODUCER_STAGES,
                                                   p[8:])}}


def phase_reg_kernels(torch, np):
    """Phase 6a: the regression scan kernel against its plain version, two
    launches bitwise equal, then its time at the main path's shape."""
    from jubatus_tpu_torch.models.regression import train_scan, train_scan_ref
    dev = torch.device("cuda")
    eps = REG_CONFIG["parameter"]["sensitivity"]
    worst = 0.0

    def check(what, w, batch, method, c):
        nonlocal worst
        got, ref, again = w.clone(), w.clone(), w.clone()
        train_scan(got, *batch, method, c, eps)
        train_scan(again, *batch, method, c, eps)
        train_scan_ref(ref, *batch, method, c, eps)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"regression_scan {what}: max |diff| {err} "
                                 f"beyond rtol 1e-5 atol 1e-6")
        if not torch.equal(got, again):
            raise AssertionError(f"regression_scan {what}: two launches "
                                 f"differ")
        if torch.equal(got, w):
            raise AssertionError(f"regression_scan {what}: no update")
        worst = max(worst, err)
        return got

    for method in ("PA", "PA1", "PA2"):
        check(f"{method} B=256 C=0.1", *reg_scan_inputs(torch, np, dev, 256,
                                                         10), method, 0.1)
    check("PA2 B=256 C=3.4e38", *reg_scan_inputs(torch, np, dev, 256, 11),
          "PA2", SHIPPED_C)
    check("PA B=8 K=4096", *reg_scan_inputs(torch, np, dev, 8, 12, k=4096,
                                            live=2304), "PA", 1.0)
    # float32 subnormals flush as under XLA: |x|^2 of [3e-20, 3e-20] is 0
    # (w stays 0); 1e-39 reads as 0 (its column stays 0)
    for vals in ([3e-20, 3e-20], [1e-39, 1.0]):
        for method in ("PA", "PA1", "PA2"):
            sub_idx = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32,
                                   device=dev)
            sub_val = torch.tensor([vals + [0.0, 0.0]], dtype=torch.float32,
                                   device=dev)
            one = torch.ones(1, dtype=torch.float32, device=dev)
            got = torch.zeros(8, dtype=torch.float32, device=dev)
            ref = got.clone()
            train_scan(got, sub_idx, sub_val, one, one, method, 1.0, eps)
            train_scan_ref(ref, sub_idx, sub_val, one, one, method, 1.0, eps)
            torch.cuda.synchronize()
            if not torch.equal(got, ref) or float(got[1]) != 0.0 or \
                    (float(got[2]) != 0.0) != (vals[1] == 1.0):
                raise AssertionError(
                    f"regression_scan {method} at the subnormal datum "
                    f"{vals}: kernel {got[:3].tolist()}, plain "
                    f"{ref[:3].tolist()}")
    # columns that recur across block boundaries and in every block in
    # flight (a pool of 40 columns)
    r = np.random.default_rng(15)
    pool = (r.integers(0, 40, (REQ_B, 16)) * 7919).astype(np.int32)
    pool[:, 9:] = 0
    pool_val = np.zeros((REQ_B, 16), np.float32)
    pool_val[:, :9] = r.standard_normal((REQ_B, 9))
    pool_tgt = (r.choice([-1.0, 1.0], REQ_B) * (2 + 2 * r.random(REQ_B))
                ).astype(np.float32)
    pool_w = torch.from_numpy((r.standard_normal(1 << 20) * 0.01).astype(
        np.float32)).to(dev)
    check("PA1 block-boundary stream B=8192", pool_w,
          [torch.from_numpy(a).to(dev) for a in
           (pool, pool_val, pool_tgt, np.ones(REQ_B, np.float32))],
          "PA1", 0.1)
    sh_w, sh_batch = reg_scan_inputs(torch, np, dev, REQ_B, 13, shared=True)
    out = check("PA shared-column stream B=8192", sh_w, sh_batch, "PA", 1.0)
    if float(out[SHARED_COL]) == float(sh_w[SHARED_COL]):
        raise AssertionError("regression_scan shared-column stream: the "
                             "shared column never moved")
    w, batch = reg_scan_inputs(torch, np, dev, REQ_B, 14)
    before = w.clone()
    one = check("PA B=8192", w, batch, "PA", 1.0)
    log(f"kernels: regression_scan within rtol 1e-5 atol 1e-6 of plain (PA, "
        f"PA1, PA2 at B=256 K=16 D=2^20; PA2 at C=3.4e38; PA at K=4096; PA1 "
        f"on a block-boundary stream; PA at B=8192 and on the shared-column "
        f"stream), two launches bitwise equal each time, max |diff| "
        f"{worst:.3g}; bitwise equal to plain at the subnormal datums")
    plan = train_scan.last_plan
    cycles = reg_scan_cycles(torch, dev, w, batch, plan, eps)
    log(f"kernels: regression_scan plan T={plan[0]} S={plan[1]} "
        f"P={plan[2]}; cycles a datum by stage {json.dumps(cycles)}")

    t_ms = time_cuda(torch, lambda: train_scan(w, *batch, "PA", 1.0, eps), 5)
    sh_ms = time_cuda(torch, lambda: train_scan(sh_w, *sh_batch, "PA", 1.0,
                                                eps), 5)
    ref = before.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_scan_ref(ref, *batch, "PA", 1.0, eps)
    torch.cuda.synchronize()
    t_plain = (time.perf_counter() - t0) * 1e3
    # bytes this batch needs: the packed batch once; w at every distinct
    # column of the live datums once; the w entries it changes written once
    k = batch[0].shape[1]
    ucols = int(torch.unique(batch[0][batch[3] > 0]).numel())
    w_written = int((one != before).sum())
    nbytes = REQ_B * (2 * k + 2) * 4 + 4 * ucols + 4 * w_written
    row = dict(ms=t_ms, plain_ms=t_plain, library_ms=None, max_abs_err=worst,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               shape=[REQ_B, k, 1 << 20], us_per_datum=t_ms * 1e3 / REQ_B,
               shared_column_ms=sh_ms,
               plan={"T": plan[0], "S": plan[1], "P": plan[2]},
               cycles_per_datum=cycles)
    log(f"kernels: regression_train_scan {row['shape']}: {t_ms:.4f} ms "
        f"({row['us_per_datum']:.4f} us a datum; shared-column stream "
        f"{sh_ms:.4f} ms; plain {t_plain:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms by bytes)")
    return row


def phase_reg_server(torch, np, card):
    """Phase 6b: the wire session against the port's regression server on
    cuda, whose train frames take the native ingest pipeline."""
    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.framework.server_base import (kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models.regression import RegressionDriver

    rng = np.random.default_rng(6)
    warm_req = reg_batch(rng, REQ_B)
    reqs = [reg_batch(rng, REQ_B) for _ in range(N_TRAIN_REQS)]
    query = [d for _, d in reg_batch(rng, 64)]
    warnings = PortWarnings()
    logging.getLogger("jubatus_tpu_torch").addHandler(warnings)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "regression.json")
        with open(cfg_path, "w") as f:
            json.dump(REG_CONFIG, f)
        server, rpc = serve(["--type", "regression", "--configpath", cfg_path,
                             "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                             "--datadir", tmp, "--device", "cuda"])
        try:
            cli = WireClient(server.args.rpc_port)
            warm_frame = cli.frame("train", warm_req)
            frames = [cli.frame("train", r) for r in reqs]
            clock = StageClock(server.driver)
            cli.call("estimate", query)
            # the server's first train request, up to a read that waits
            t0 = time.perf_counter()
            cli.send(warm_frame, "train")
            cli.call("estimate", query[:1])
            warm_split = clock.split(t0, time.perf_counter())
            reset_kernel_launches()
            marks = []
            t0 = time.perf_counter()
            for frame in frames:
                marks.append(time.perf_counter())
                n = cli.send(frame, "train")
                if n != REQ_B:
                    raise AssertionError(f"train acknowledged {n!r} datums")
            marks.append(time.perf_counter())
            est = cli.call("estimate", query)    # reads w back: a fence
            train_s = time.perf_counter() - t0
            timed_split = [clock.split(a, b)
                           for a, b in zip(marks, marks[1:])]
            clock.close()

            # the card's time seen by torch.profiler: the same frames
            # again, up to a read
            def again():
                for frame in frames:
                    cli.send(frame, "train")
                cli.call("estimate", query[:1])

            busy_ms, busy_wall_ms = time_device_busy(torch, again)
            lat = []
            for i in range(20):
                t1 = time.perf_counter()
                cli.call("estimate", [query[i]])
                lat.append((time.perf_counter() - t1) * 1e3)
            before = cli.call("estimate", query)
            saved = cli.call("save", "smoke")
            cleared = cli.call("clear")
            zeros = cli.call("estimate", query)
            loaded = cli.call("load", "smoke")
            after = cli.call("estimate", query)
            status = cli.call("get_status")
            cli.close()
            counts = kernel_launches()
        finally:
            rpc.stop()
            server.stop()
    logging.getLogger("jubatus_tpu_torch").removeHandler(warnings)
    warnings.check("phase 6 regression server session")

    sent = REQ_B * (2 * N_TRAIN_REQS + 1)
    got = np.array(est, np.float64)
    if got.shape != (len(query),) or not np.isfinite(got).all() \
            or not np.abs(got).max() > 0:
        raise AssertionError("estimate not finite and non-zero per datum")
    if not (len(saved) == 1 and cleared is True and loaded is True):
        raise AssertionError(f"save/clear/load failed: {saved!r} {cleared!r} "
                             f"{loaded!r}")
    if zeros != [0.0] * len(query) or after != before:
        raise AssertionError("estimate not 0 after clear, or changed across "
                             "save/load")
    (st,) = status.values()
    if (st["fast_path"], st["ingest_pipeline"]) != ("True", "1") \
            or st["device"].split(":")[0] != "cuda":
        raise AssertionError(f"the regression server's train path is not the "
                             f"native ingest pipeline on cuda: {st}")
    if int(st["num_trained"]) != sent:
        raise AssertionError(f"num_trained {st['num_trained']}, sent {sent}")
    if int(st["kernel_launches.regression_train_scan"]) <= 0 \
            or counts["regression_train_scan"] <= 0:
        raise AssertionError("the regression scan kernel never launched on "
                             "the main path")
    # the CPU driver (the plain version) fed the same frames
    splitter = native.load()
    cpu = RegressionDriver(REG_CONFIG, device="cpu")
    for f in [warm_frame] + frames:
        cpu.train_raw(f, splitter.parse_envelope(f, 0)[4])
    # est was read before the profiled pass: the same model state
    ref = np.array(cpu.estimate([Datum.from_msgpack(d) for d in query]))
    if not np.allclose(got, ref, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"regression server vs cpu driver: max |diff| "
                             f"{np.abs(got - ref).max()}")
    line = {"samples_per_s": REQ_B * N_TRAIN_REQS / train_s,
            "train_request_ms": [(b - a) * 1e3
                                 for a, b in zip(marks, marks[1:])],
            "request_split_ms": {"warm": warm_split, "timed": timed_split},
            # the profiler's readings alone, no busy share: it sees less
            # device time than the pass's scan launches take (PERF.md §7)
            "device_busy_ms": busy_ms, "device_busy_wall_ms": busy_wall_ms,
            "estimate_ms_p50": float(np.median(lat)),
            "estimate_max_abs_diff_vs_cpu": float(np.abs(got - ref).max()),
            "train_requests": N_TRAIN_REQS, "datums_per_request": REQ_B,
            "scan_launches": counts["regression_train_scan"], "card": card}
    log("regression: " + json.dumps(line))
    return counts


def phase_reg_mix(torch, np):
    """Phase 6c: one v3 MIX round between two regression drivers on the
    card, against the same round on the f32 wire."""
    from jubatus_tpu_torch.framework.server_base import (kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.mix import codec
    from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
    from jubatus_tpu_torch.models.regression import RegressionDriver

    rng = np.random.default_rng(7)
    halves = [[(y, Datum.from_msgpack(d)) for y, d in reg_batch(rng, REQ_B)]
              for _ in range(2)]

    def trained():
        drivers = [RegressionDriver(REG_CONFIG, device="cuda")
                   for _ in range(2)]
        for d, half in zip(drivers, halves):
            d.train(half)
        return drivers

    def wire(diff, quantize, stats):
        return codec.decode(codec.unpackb(codec.packb(
            encode_wire_diff(diff, quantize, "cuda", stats))), "cuda")

    def mix_round(drivers, quantize, stats=None):
        diffs = [wire(d.encode_diff(d.get_diff()), quantize, stats)
                 for d in drivers]
        merged = RegressionDriver.mix(diffs[0], diffs[1])
        back = wire(merged, quantize, stats)
        for d in drivers:
            d.put_diff(back)
        torch.cuda.synchronize()
        return merged

    exact = trained()
    mix_round(exact, False)
    quant = trained()
    torch.cuda.synchronize()
    reset_kernel_launches()
    stats = {}
    merged = mix_round(quant, True, stats)
    counts = kernel_launches()
    if not torch.equal(quant[0].w, quant[1].w):
        raise AssertionError("regression v3 round: replicas differ in w")
    drift = float((quant[0].w - exact[0].w).abs().max())
    if drift > stats["max_abs_err"]:
        raise AssertionError(f"regression v3 round: w drift {drift} beyond "
                             f"the bound {stats['max_abs_err']}")
    if counts["quantize_int8"] <= 0 or counts["dequantize_int8"] <= 0:
        raise AssertionError(f"quantizer kernels not launched on the "
                             f"regression diff: {counts}")
    on_card = codec.packb(encode_wire_diff(merged, True, "cuda"))
    if on_card != codec.packb(encode_wire_diff(merged, True, "cpu")):
        raise AssertionError("v3 wire bytes of the merged regression diff "
                             "differ between the card's codec and the host's")
    log(f"mix: regression diff of {merged['cols'].size} columns, wire "
        f"{stats['wire']} bytes for {stats['raw']} f32 bytes; replicas "
        f"bitwise equal; w drift from the f32 round {drift:.3g} <= bound "
        f"{stats['max_abs_err']:.3g}; quantize_int8 launches "
        f"{counts['quantize_int8']}, dequantize_int8 launches "
        f"{counts['dequantize_int8']}")
    return counts


class Child:
    """A subprocess of the cluster phase (python -m MODULE ...) run from
    this checkout; a thread drains its output and keeps the last lines
    for an error message."""

    def __init__(self, argv):
        import queue
        import threading
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.p = subprocess.Popen([sys.executable, "-m", *argv], cwd=HERE,
                                  env=env, text=True, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
        self.lines = queue.Queue()
        self.tail = []
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.p.stdout:
            self.tail = (self.tail + [line])[-40:]
            self.lines.put(line)
        self.lines.put(None)

    def wait_line(self, prefix, timeout):
        import queue
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(
                    timeout=max(0.05, deadline - time.monotonic()))
            except queue.Empty:
                line = ""
            if line is None:
                raise AssertionError("a cluster process ended:\n"
                                     + "".join(self.tail))
            if line.startswith(prefix):
                return line
            if time.monotonic() > deadline:
                raise AssertionError(f"no {prefix!r} line within {timeout} s:"
                                     "\n" + "".join(self.tail))

    def stop(self):
        if self.p.poll() is None:
            self.p.terminate()
            try:
                self.p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait(timeout=15)

    def kill(self):
        """SIGKILL: the crash the durability plane recovers from."""
        self.p.kill()
        self.p.wait(timeout=15)


def start_server(service, cfg_path, tmp, *extra, device="cuda"):
    """A port server subprocess on `device`; (child, its start time)."""
    return Child(["jubatus_tpu_torch.cli.server", "--type", service,
                  "--configpath", cfg_path, "--rpc-port", "0",
                  "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1",
                  "--datadir", tmp, "--device", device, *extra]), \
        time.perf_counter()


def server_ready(child, t0):
    """(port, ms from the process's start to its `jubatus ready` line)."""
    port = int(child.wait_line("jubatus ready", 300).split()[2]
               .split("=")[1])
    return port, (time.perf_counter() - t0) * 1e3


def status_of(cli):
    return next(iter(cli.call("get_status").values()))


def launches_of(st):
    """A server's kernel launches by kernel, from its get_status."""
    return {k.split(".", 1)[1]: int(v) for k, v in st.items()
            if k.startswith("kernel_launches.")}


def model_tables(np, pack, service):
    """A driver's pack as {key: array}: the classifier's w and cov rows
    and counts keyed by label (rows are numbered per process), the
    regression's w."""
    if service == "regression":
        return {"w": np.frombuffer(pack["w"], np.float32)}
    labels = {(k.decode() if isinstance(k, bytes) else k): int(v)
              for k, v in pack["labels"].items()}
    cap, dim = int(pack["capacity"]), int(pack["dim"])
    out = {}
    for name in ("w", "cov"):
        t = np.frombuffer(pack[name], np.float32).reshape(cap, dim)
        out.update({f"{name}:{lbl}": t[row] for lbl, row in labels.items()})
    counts = np.frombuffer(pack["counts"], np.int32)
    out.update({f"count:{lbl}": counts[row:row + 1]
                for lbl, row in labels.items()})
    return out


def same_tables(np, a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


def phase_cluster(torch, np, card, service, device="cuda"):
    """Phase 7: a cross-process v3 MIX round.  The port's coordinator and
    two port servers (device cuda, --mix_quantize, a trigger out of
    reach, each with its own --journal and no snapshot timer) run as
    subprocesses; each server is trained over the wire on its own
    8192-datum half, then do_mix on one.  The replicas must be
    bitwise equal to each other and to the same v3 round run here on two
    drivers fed the same frames through their raw entry (in the
    master's member order), whose drift from its f32 twin stays within
    the round's accumulated quantization bound; the classifier's counts
    must be the exact sum of both halves; a second do_mix on the other
    server must change nothing; and both quantizer kernels must have
    launched in each server process.  After a third round, server 1 is
    SIGKILLed and restarted on its journal directory: it must come back
    bitwise equal to its model before the kill, having replayed its
    journaled scatters through dequantize_int8 in its new process.
    Returns the servers' kernel launches (the restarted process's
    included), summed."""
    from collections import Counter

    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.cluster.membership import MembershipClient
    from jubatus_tpu_torch.mix import codec
    from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.rpc.client import Client

    cfg = SERVER_CONFIG if service == "classifier" else REG_CONFIG
    rng = np.random.default_rng(11)
    halves = ([bench_batch(rng, REQ_B, label_offset=h) for h in range(2)]
              if service == "classifier"
              else [reg_batch(rng, REQ_B) for _ in range(2)])
    name = f"smoke_{service}"

    def model_of(port):
        with Client("127.0.0.1", port, timeout=600) as c:
            return model_tables(np, codec.decode(
                c.call_raw("get_model", 0))["model"], service)

    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, f"{service}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        try:
            coord = Child(["jubatus_tpu_torch.cluster.coordinator",
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1"])
            children.append(coord)
            addr = coord.wait_line("jubacoordinator", 120).split()[-1]
            argv = [[
                "jubatus_tpu_torch.cli.server", "--type", service,
                "--configpath", cfg_path, "--name", name, "--rpc-port", "0",
                "--listen_addr", "127.0.0.1", "--eth", "127.0.0.1",
                "--datadir", tmp, "--device", device, "--coordinator", addr,
                "--mix_quantize", "--interval_sec", "100000",
                "--interval_count", "1000000",
                "--journal", os.path.join(tmp, f"dur{i}"),
                "--journal_fsync", "batch", "--snapshot_interval", "0"]
                for i in range(2)]
            servers = [Child(a) for a in argv]
            children.extend(servers)
            ports = [int(s.wait_line("jubatus ready", 300).split()[2]
                         .split("=")[1]) for s in servers]
            membership = MembershipClient(addr, service, name)
            deadline = time.monotonic() + 60
            while set(membership.get_all_nodes()) != \
                    {("127.0.0.1", p) for p in ports}:
                if time.monotonic() > deadline:
                    raise AssertionError(f"{service} cluster: both servers "
                                         "never listed in get_all_nodes")
                time.sleep(0.1)
            # the master folds in this order
            order = [ports.index(p) for _, p in membership.get_all_nodes()]
            membership.close()
            clients = [WireClient(p) for p in ports]
            frames = [c.frame("train", h) for c, h in zip(clients, halves)]
            for c, fr in zip(clients, frames):
                if c.send(fr, "train") != REQ_B:
                    raise AssertionError(f"{service} cluster: a train "
                                         "request was not acknowledged")
            t0 = time.perf_counter()
            if clients[0].call("do_mix") is not True:
                raise AssertionError(f"{service} cluster: do_mix failed")
            do_mix_ms = (time.perf_counter() - t0) * 1e3
            status = [next(iter(c.call("get_status").values()))
                      for c in clients]
            models = [model_of(p) for p in ports]
            if service == "classifier":
                want = Counter(lbl for h in halves for lbl, _ in h)
                for c in clients:
                    if c.call("get_labels") != dict(want):
                        raise AssertionError("classifier cluster: label "
                                             "counts are not the halves' sum")
            if clients[1].call("do_mix") is not True:
                raise AssertionError(f"{service} cluster: 2nd do_mix failed")
            for p, before in zip(ports, models):
                after = model_of(p)
                if not same_tables(np, after, before):
                    moved = max(float(np.abs(after[k] - before[k]).max())
                                for k in before)
                    raise AssertionError(f"{service} cluster: the second "
                                         f"do_mix moved a model by {moved}")
            # a third round on fresh halves in the same processes: the
            # round's time once each process has run every step before
            # (the first round pays each process's first CUDA calls)
            more = ([bench_batch(rng, REQ_B, label_offset=h)
                     for h in range(2)] if service == "classifier"
                    else [reg_batch(rng, REQ_B) for _ in range(2)])
            for c, h in zip(clients, more):
                if c.send(c.frame("train", h), "train") != REQ_B:
                    raise AssertionError(f"{service} cluster: a train "
                                         "request was not acknowledged")
            t0 = time.perf_counter()
            if clients[0].call("do_mix") is not True:
                raise AssertionError(f"{service} cluster: 3rd do_mix failed")
            warm_ms = (time.perf_counter() - t0) * 1e3
            warm = [next(iter(c.call("get_status").values()))
                    for c in clients]
            third = [model_of(p) for p in ports]
            if not same_tables(np, third[0], third[1]):
                raise AssertionError(f"{service} cluster: replicas differ "
                                     "after the third round")
            if service == "classifier":
                want = Counter(lbl for h in halves + more for lbl, _ in h)
                for c in clients:
                    if c.call("get_labels") != dict(want):
                        raise AssertionError("classifier cluster: label "
                                             "counts after the third round "
                                             "are not the four halves' sum")
            for c in clients:
                c.close()
            # the journaled scatters: SIGKILL server 1, restart it on its
            # directory; it replays its train windows and the three
            # applied v3 scatters (dequantize_int8 in the new process)
            servers[1].kill()
            t0 = time.perf_counter()
            servers[1] = Child(argv[1])
            children.append(servers[1])
            port1 = int(servers[1].wait_line("jubatus ready", 300).split()[2]
                        .split("=")[1])
            reboot_ms = (time.perf_counter() - t0) * 1e3
            cli = WireClient(port1)
            restarted = status_of(cli)
            cli.close()
            recovered = model_of(port1)
        finally:
            for ch in children:
                ch.stop()

    # the same v3 round on two drivers in this process, and its f32 twin
    splitter = native.load()

    def round_here(quantize, stats=None):
        drivers = [create_driver(service, cfg, device=device)
                   for _ in range(2)]
        for d, fr in zip(drivers, frames):
            d.train_raw(fr, splitter.parse_envelope(fr, 0)[4])

        def wire(x):
            return codec.decode(codec.unpackb(codec.packb(encode_wire_diff(
                x, quantize, device, stats))), device)

        got = [wire(drivers[i].encode_diff(drivers[i].get_diff_snapshot()))
               for i in order]
        merged = got[0]
        for g in got[1:]:
            merged = type(drivers[0]).mix(merged, g)
        back = wire(merged)
        for d in drivers:
            d.put_diff(back)
        return [model_tables(np, d.pack(), service) for d in drivers]

    stats = {}
    here = round_here(True, stats)
    exact = round_here(False)
    if restarted["recovery_errors"] != "0" or \
            int(restarted["recovery_replayed"]) < 4:
        raise AssertionError(f"{service} cluster: the restarted server "
                             f"replayed {restarted['recovery_replayed']} "
                             f"records, {restarted['recovery_errors']} "
                             "errors (want its windows and 3 scatters)")
    if not same_tables(np, recovered, third[1]):
        raise AssertionError(f"{service} cluster: the restarted server's "
                             "model differs from its model before the kill")
    for i, m in enumerate(models):
        if not same_tables(np, m, models[0]):
            raise AssertionError(f"{service} cluster: replicas differ")
        if not same_tables(np, m, here[i]):
            raise AssertionError(f"{service} cluster: server {i} differs "
                                 "from the in-process v3 round")
    drift = max(float(np.abs(here[0][k] - exact[0][k]).max())
                for k in here[0] if not k.startswith("count:"))
    if drift > stats["max_abs_err"]:
        raise AssertionError(f"{service} cluster: drift {drift} beyond the "
                             f"bound {stats['max_abs_err']}")
    launches = {}
    # each server's launches to its first round, as in PR 7's table, and
    # the restarted process's
    for st in status + [restarted]:
        for kern, n in launches_of(st).items():
            launches[kern] = launches.get(kern, 0) + n
    for st in status:
        for kern in ("quantize_int8", "dequantize_int8"):
            if device == "cuda" and int(st[f"kernel_launches.{kern}"]) <= 0:
                raise AssertionError(f"{service} cluster: {kern} never "
                                     "launched in a server process")
    scan = "train_scan" if service == "classifier" else \
        "regression_train_scan"
    for kern in ("dequantize_int8", scan):
        if device == "cuda" and launches_of(restarted)[kern] <= 0:
            raise AssertionError(f"{service} cluster: {kern} never launched "
                                 "in the restarted server's replay")
    master = status[0]

    def legs_ms(sts):
        """Each server's get_diff handler (snapshot, subtraction, wire
        encode) and put_diff handler (decode, fold), in ms."""
        return {leg: [float(st[f"last_{leg}_sec"]) * 1e3 for st in sts]
                for leg in ("get_diff_snapshot", "get_diff_encode",
                            "get_diff_wire", "put_diff_decode",
                            "put_diff_apply")}

    line = {
        "service": service, "do_mix_ms": do_mix_ms,
        "last_mix_sec": float(master["last_mix_sec"]),
        "last_mix_bytes": int(master["last_mix_bytes"]),
        "last_mix_wire_bytes": int(master["last_mix_wire_bytes"]),
        "mix_round": int(master["mix_round"]),
        "stages_ms": {st: float(master[f"last_mix_{st}_sec"]) * 1e3
                      for st in ("gather", "decode", "fold", "encode",
                                 "scatter")},
        "legs_ms": legs_ms(status),
        "mix_compression_ratio": float(master["mix_compression_ratio"]),
        "quantize_launches": [int(st["kernel_launches.quantize_int8"])
                              for st in status],
        "dequantize_launches": [int(st["kernel_launches.dequantize_int8"])
                                for st in status],
        "drift": drift, "bound": stats["max_abs_err"],
        "warm_round": {
            "do_mix_ms": warm_ms,
            "last_mix_sec": float(warm[0]["last_mix_sec"]),
            "last_mix_wire_bytes": int(warm[0]["last_mix_wire_bytes"]),
            "mix_round": int(warm[0]["mix_round"]),
            "stages_ms": {st: float(warm[0][f"last_mix_{st}_sec"]) * 1e3
                          for st in ("gather", "decode", "fold", "encode",
                                     "scatter")},
            "legs_ms": legs_ms(warm)},
        "restart": {"boot_to_routable_ms": reboot_ms,
                    "recovery_replayed": int(restarted["recovery_replayed"]),
                    "recovery_replay_ms": float(
                        restarted["recovery_replay_ms"]),
                    "launches": launches_of(restarted)},
        "card": card}
    log(f"cluster: {service}: two server processes and the in-process v3 "
        f"round bitwise equal; drift from the f32 twin {drift:.3g} <= "
        f"bound {stats['max_abs_err']:.3g}; second do_mix changed nothing; "
        f"server 1 SIGKILLed and recovered bitwise from "
        f"{restarted['recovery_replayed']} journal records")
    log("cluster_mix " + json.dumps(line))
    return launches


# seconds between a durable server's background snapshots: the first
# fires after the phase's first two requests, the next after the kill
SNAPSHOT_S = 8          # the journaled server's snapshot timer (15 s
#                         before phase 17 came)
LANE_THREADS = 32
LANE_CALLS = 64             # one-datum reads per client thread
LANE_WINDOW_US = 200


def saved_tables(np, cli, service, cfg):
    """The server's model through its save RPC: the file read back with
    the port's load_model, as tables."""
    from jubatus_tpu_torch.framework.save_load import load_model
    from jubatus_tpu_torch.framework.server_base import USER_DATA_VERSION
    (path,) = cli.call("save", "durable").values()
    with open(path, "rb") as fp:
        data = load_model(fp, server_type=service,
                          expected_config=json.dumps(cfg),
                          user_data_version=USER_DATA_VERSION)
    return model_tables(np, data, service)


def phase_durable(torch, np, card, service, device="cuda"):
    """Phase 8: the durable server.  Two port servers on cuda as
    subprocesses, one with --journal (fsync batch, a snapshot timer) and
    one without, get the same four 8192-datum train requests (each timed,
    in turns); after the first two the journaled server's first snapshot
    is awaited.  Then SIGKILL and a restart on the same directory: it
    must restore the snapshot, replay the two windows after it with no
    error, launch its scan kernel once per replayed window, answer a read
    bitwise as a driver here fed the same four frames through its raw
    entry does, and hold that driver's model bitwise (its save, read
    back).  Returns the servers' kernel launches, summed."""
    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver

    cfg = SERVER_CONFIG if service == "classifier" else REG_CONFIG
    scan = "train_scan" if service == "classifier" else \
        "regression_train_scan"
    read = "classify" if service == "classifier" else "estimate"
    rng = np.random.default_rng(8)
    reqs = ([bench_batch(rng, REQ_B) for _ in range(4)]
            if service == "classifier"
            else [reg_batch(rng, REQ_B) for _ in range(4)])
    query = [d for _, d in reqs[0][:N_LABELS]]
    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, f"{service}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        journaled = ["--journal", os.path.join(tmp, "dur"),
                     "--journal_fsync", "batch",
                     "--snapshot_interval", str(SNAPSHOT_S)]
        try:
            dur, t_dur = start_server(service, cfg_path, tmp, *journaled,
                                      device=device)
            plain, t_plain = start_server(service, cfg_path, tmp,
                                          device=device)
            children += [dur, plain]
            port, boot_ms = server_ready(dur, t_dur)
            clis = {"journal": WireClient(port),
                    "plain": WireClient(server_ready(plain, t_plain)[0])}
            frames = [clis["journal"].frame("train", r) for r in reqs]
            req_ms = {"journal": [], "plain": []}

            def send(i):
                # in turns: the first server alternates per request
                order = ("journal", "plain") if i % 2 == 0 \
                    else ("plain", "journal")
                for k in order:
                    t0 = time.perf_counter()
                    if clis[k].send(frames[i], "train") != REQ_B:
                        raise AssertionError(f"durable {service}: a train "
                                             "request was not acknowledged")
                    req_ms[k].append((time.perf_counter() - t0) * 1e3)

            send(0)
            send(1)
            deadline = time.monotonic() + 4 * SNAPSHOT_S
            while int(status_of(clis["journal"])["snapshot_count"]) < 1:
                if time.monotonic() > deadline:
                    raise AssertionError(f"durable {service}: no snapshot "
                                         "was published")
                time.sleep(0.2)
            snap = status_of(clis["journal"])
            send(2)
            send(3)
            before = status_of(clis["journal"])
            plain_launches = launches_of(status_of(clis["plain"]))
            for c in clis.values():
                c.close()
            dur.kill()
            dur, t_dur = start_server(service, cfg_path, tmp, *journaled,
                                      device=device)
            children.append(dur)
            port, reboot_ms = server_ready(dur, t_dur)
            cli = WireClient(port)
            st = status_of(cli)
            answer = cli.call(read, query)
            recovered = saved_tables(np, cli, service, cfg)
            cli.close()
        finally:
            for ch in children:
                ch.stop()

    replayed = int(st["recovery_replayed"])
    if (st["recovery_restored"], st["recovery_errors"]) != ("1", "0") \
            or replayed < 2:
        raise AssertionError(
            f"durable {service}: restored {st['recovery_restored']}, "
            f"replayed {replayed}, errors {st['recovery_errors']} (want a "
            "snapshot restored and at least the 2 windows after it)")
    if device == "cuda" and launches_of(st)[scan] != replayed:
        raise AssertionError(f"durable {service}: {scan} launched "
                             f"{launches_of(st)[scan]} times replaying "
                             f"{replayed} windows")
    # the uncrashed twin: the same four frames through the raw entry
    twin = create_driver(service, cfg, device=device)
    splitter = native.load()
    for fr in frames:
        twin.train_raw(fr, splitter.parse_envelope(fr, 0)[4])
    if not same_tables(np, recovered, model_tables(np, twin.pack(),
                                                   service)):
        raise AssertionError(f"durable {service}: the recovered model "
                             "differs from the uncrashed driver's")
    qd = [Datum.from_msgpack(d) for d in query]
    want = ([[[lbl, sc] for lbl, sc in row] for row in twin.classify(qd)]
            if service == "classifier" else twin.estimate(qd))
    if answer != want:
        raise AssertionError(f"durable {service}: the recovered server's "
                             f"{read} differs from the uncrashed driver's")
    line = {
        "service": service,
        "request_ms": req_ms,
        "journal": {k: before[k] for k in (
            "journal_position", "journal_records_total",
            "journal_bytes_total", "journal_fsync_total")
            if k in before},
        "snapshot": {"bytes": int(snap["snapshot_last_bytes"]),
                     "pack_ms": float(snap["snapshot_last_pack_ms"]),
                     "write_ms": float(snap["snapshot_last_write_ms"]),
                     "sync_ms": float(snap["snapshot_last_sync_ms"])},
        "recovery": {"restore_ms": float(st["recovery_restore_ms"]),
                     "replay_ms": float(st["recovery_replay_ms"]),
                     "replayed": replayed,
                     "replay_ms_per_record":
                         float(st["recovery_replay_ms"]) / replayed,
                     "boot_to_routable_ms": reboot_ms,
                     "first_boot_ms": boot_ms,
                     "reanchor_snapshot": {
                         "pack_ms": float(st["snapshot_last_pack_ms"]),
                         "write_ms": float(st["snapshot_last_write_ms"]),
                         "sync_ms": float(st["snapshot_last_sync_ms"])}},
        "launches": {"journaled_before_kill": launches_of(before),
                     "plain": plain_launches,
                     "restarted": launches_of(st)},
        "card": card}
    log(f"durable: {service}: SIGKILL after 4 acked requests; restored "
        f"{st['recovery_source']}, replayed {replayed} windows through "
        f"{scan} ({launches_of(st)[scan]} launches), model bitwise equal "
        "to the uncrashed driver's")
    log("durable " + json.dumps(line))
    launches = {}
    for counts in line["launches"].values():
        for kern, n in counts.items():
            launches[kern] = launches.get(kern, 0) + n
    return launches


def lane_reads(lat, answers, port, read, queries, idx):
    """One client thread of phase 9: one-datum reads of queries[i] for i
    in idx, each timed."""
    cli = WireClient(port)
    try:
        for i in idx:
            t0 = time.perf_counter()
            answers[i] = cli.call(read, [queries[i]])
            lat[i] = (time.perf_counter() - t0) * 1e3
    finally:
        cli.close()


def phase_read_lane(torch, np, card, service, device="cuda"):
    """Phase 9: the read lane.  Two port servers on cuda as subprocesses,
    one with --read_batch_window_us 200 and one without, trained alike
    (a warm and 4 timed 8192-datum requests, as phase 4).  32 client
    threads each send 64 one-datum reads to each server in turn; every
    answer of the lane server must be bitwise the answer of the same
    read sent alone (one client, one read at a time, on that server),
    and its sweeps must have fused reads (read_batch_size mean > 1).
    Then the driver's *_many alone on the card at B 1, 16 and 64 (CUDA
    events).  Returns the servers' kernel launches, summed."""
    import threading

    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver

    cfg = SERVER_CONFIG if service == "classifier" else REG_CONFIG
    read = "classify" if service == "classifier" else "estimate"
    many = "classify_many" if service == "classifier" else "estimate_many"
    batch = bench_batch if service == "classifier" else reg_batch
    rng = np.random.default_rng(9)
    reqs = [batch(rng, REQ_B) for _ in range(N_TRAIN_REQS + 1)]
    n = LANE_THREADS * LANE_CALLS
    queries = [d for _, d in batch(rng, n)]
    out = {}
    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, f"{service}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        try:
            started = {
                "lane": start_server(service, cfg_path, tmp,
                                     "--read_batch_window_us",
                                     str(LANE_WINDOW_US), device=device),
                "plain": start_server(service, cfg_path, tmp,
                                      device=device)}
            children += [c for c, _ in started.values()]
            ports = {k: server_ready(*v)[0] for k, v in started.items()}
            for k, port in ports.items():
                cli = WireClient(port)
                frames = [cli.frame("train", r) for r in reqs]
                for fr in frames:
                    if cli.send(fr, "train") != REQ_B:
                        raise AssertionError(f"read lane {service}: a train "
                                             "request was not acknowledged")
                cli.call(read, queries[:1])          # warm
                cli.close()
            for k in ("lane", "plain", "lane", "plain"):
                lat, answers = [0.0] * n, [None] * n
                threads = [threading.Thread(
                    target=lane_reads,
                    args=(lat, answers, ports[k], read, queries,
                          range(t, n, LANE_THREADS)))
                    for t in range(LANE_THREADS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                if any(t.is_alive() for t in threads) or None in answers:
                    raise AssertionError(f"read lane {service}: a client "
                                         "thread did not finish")
                out.setdefault(k, []).append((lat, answers))
            cli = WireClient(ports["lane"])
            lane_st = status_of(cli)
            alone = [cli.call(read, [q]) for q in queries]
            cli.close()
            counts = {}
            for port in ports.values():
                cli = WireClient(port)
                for kern, c in launches_of(status_of(cli)).items():
                    counts[kern] = counts.get(kern, 0) + c
                cli.close()
        finally:
            for ch in children:
                ch.stop()

    for lat, answers in out["lane"]:
        if answers != alone:
            bad = sum(a != b for a, b in zip(answers, alone))
            raise AssertionError(f"read lane {service}: {bad} of {n} lane "
                                 "answers differ from the read sent alone")
    mean = float(lane_st["read_batch_size_mean"])
    if not mean > 1.0:
        raise AssertionError(f"read lane {service}: read_batch_size mean "
                             f"{mean}: the lane fused no reads")
    same_plain = all(a == alone for _, a in out["plain"])

    # the driver's fused sweep alone on the card, by CUDA events
    drv = create_driver(service, cfg, device=device)
    splitter = native.load()
    for fr in frames:
        drv.train_raw(fr, splitter.parse_envelope(fr, 0)[4])
    many_ms = {}
    for b in (1, 16, 64):
        groups = [[Datum.from_msgpack(q)] for q in queries[:b]]
        if device == "cuda":
            many_ms[b] = time_cuda(
                torch, lambda: getattr(drv, many)(groups), 20)

    def pct(k, q):
        return [float(np.percentile(lat, q)) for lat, _ in out[k]]

    line = {
        "service": service, "threads": LANE_THREADS, "calls": n,
        "window_us": LANE_WINDOW_US,
        f"{read}_ms_p50": {"lane": pct("lane", 50), "plain": pct("plain", 50)},
        f"{read}_ms_p99": {"lane": pct("lane", 99), "plain": pct("plain", 99)},
        "read_batch_size_mean": mean,
        "read_batch_size_max": float(lane_st["read_batch_size_max"]),
        "read_batch_size_count": int(lane_st["read_batch_size_count"]),
        "read_lock_wait_p99_ms": float(
            lane_st["read_lock_wait_p99_sec"]) * 1e3,
        "plain_answers_equal": same_plain,
        f"{many}_ms": many_ms,
        "card": card}
    log(f"read lane: {service}: {4 * n} reads from {LANE_THREADS} threads, "
        f"each lane answer bitwise the read sent alone; read_batch_size "
        f"mean {mean:.2f}, max {line['read_batch_size_max']:.0f}")
    log("read_lane " + json.dumps(line))
    return counts


# ---------------------------------------------------------------------------
# 10. nearest_neighbor: the LSH kernels, the service at 10^6 rows, MIX and
# recovery
# ---------------------------------------------------------------------------

# bench.py's nearest_neighbor converter (bench.py:1004-1007) with lsh at
# hash_num 64 (bench.py:981)
NN_CONFIG = {
    "method": "lsh", "parameter": {"hash_num": 64},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 4096},
}
# rows of the service's table: bench.py:1199's 10^6 cut to a quarter so
# the whole smoke stays within half its time limit with phase 11 (the
# sweep kernels are still timed over 10^6 rows: NN_SWEEP_ROWS)
NN_ROWS = 250_000
NN_BATCH = 1024            # rows a set_row_many call while building it
NN_KEYS = 1024             # feature names a datum draws from
NN_NNZ = 16                # features a datum
NN_NEW = 1024              # set_row calls over the wire
NN_READS = 256             # calls of each read method over the wire
NN_SIZE = 10               # their result size
NN_CLUSTER_ROWS = 2048     # set_row calls to each cluster server (4,096
                           # before phase 15 came; ROADMAP's floor)
NN_SWEEP_ROWS = 10 ** 6    # rows of the sweep kernel's tables
NN_SIG_B = 1024            # datums of the signature kernels' batches
NN_RTOL = NN_ATOL = 1e-6   # euclid_lsh scores
NN_KB = 16                 # kb of a read at NN_SIZE: _round_k(10)
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# the card's other rates, each class at its own: 132 SMs at the H100
# SXM's 1.98 GHz boost (data sheet) times the results a clock an SM of
# the CUDA programming guide's throughput table for compute capability
# 9.0: 64 for 32-bit integer add, logical, shift, compare and select; 16
# for population count; 16 for the special function unit (log, sqrt,
# reciprocal)
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9
INT32_OPS_PER_S = 64 * SM_COUNT * SM_CLOCK_HZ
POPC_PER_S = 16 * SM_COUNT * SM_CLOCK_HZ
SFU_PER_S = 16 * SM_COUNT * SM_CLOCK_HZ
# float32 operations of one (feature, hash) draw of K1 (the uniform's 3;
# XLA's log1p about 30: its log's range reduction 8, 9 multiply-adds of
# 2, 5 multiplies and adds, or its rational's 12 multiply-adds of 2, a
# division and 5 more; the erf_inv's compare, select and sqrt-or-subtract
# 3, its 8 fused multiply-adds 16, its product and the sqrt(2) 2, the
# projection's fused multiply-add 2) and of K2 (uniform 2, XLA's log
# about 30, negate, max, divide, compare 4)
K1_F32_OPS = 56
K2_F32_OPS = 36
# integer operations: threefry2x32 is 72 (the 2 key adds, 20 rounds of
# add, rotate and xor, 5 key injections of 2 adds); a draw adds hi ^ lo
# and the uniform's shift and or; a fold key is one threefry a (datum,
# feature).  Special-function operations of a draw: K1's log1p, K2's log
# and the reciprocal of its division
THREEFRY_INT_OPS = 72
DRAW_INT_OPS = THREEFRY_INT_OPS + 3
K1_SFU_OPS, K2_SFU_OPS = 1, 2


def nn_datums(np, rng, n):
    """n datums as (names, values) lists: NN_NNZ distinct features of
    NN_KEYS names (an odd stride from a random start), standard normal
    values."""
    start = rng.integers(0, NN_KEYS, n)[:, None]
    stride = (2 * rng.integers(0, NN_KEYS // 2, n) + 1)[:, None]
    keys = (start + stride * np.arange(NN_NNZ)[None, :]) % NN_KEYS
    vals = rng.standard_normal((n, NN_NNZ))
    names = [f"f{k}" for k in range(NN_KEYS)]
    return [([names[k] for k in ks], vs)
            for ks, vs in zip(keys.tolist(), vals.tolist())]


def nn_wire(d):
    return [[], [[k, v] for k, v in zip(*d)], []]


def nn_datum(Datum, d):
    return Datum([], list(zip(*d)))


def nn_times(torch, fn, device, calls):
    """(ms, method, call_ms) of one wrapper call: the card's time alone
    (time_device: `calls` calls in a CUDA graph) where it captures, else
    the call time; call_ms is CUDA events around eager calls, the host's
    pace where that is the slower.  None on the CPU."""
    if device != "cuda":
        return None, None, None
    call_ms = time_cuda(torch, fn, 50)
    dev_ms, method = time_device(torch, fn, calls)
    return (call_ms if dev_ms is None else dev_ms), method, call_ms


def nn_sig_batch(torch, np, dev, seed, b=NN_SIG_B):
    """b datums of NN_NNZ features; at b > 2 an empty one and a
    half-padded one among them."""
    rng = np.random.default_rng(seed if b == NN_SIG_B else seed + b)
    idx = rng.integers(0, 4096, (b, NN_NNZ)).astype(np.int32)
    val = rng.standard_normal((b, NN_NNZ)).astype(np.float32)
    if b > 2:
        idx[0], val[0] = 0, 0.0                # an empty datum
        val[1, NN_NNZ // 2:] = 0.0             # a half-padded one
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev))


def nn_bits(torch, sig, h):
    """[B, W] int32 signature words -> [B, h] bool."""
    w = sig.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(32, device=sig.device)
    return ((w[..., None] >> sh) & 1).reshape(sig.shape[0], -1)[:, :h] > 0


def sig_variant(idx, nz, out, h, f32, sfu, ms, method, call_ms, plain_ms,
                in_band, err):
    """A K1 or K2 report row at one shape: its times and its bound by
    class, from a batch idx [B, K] of nz nonzero values signed into out
    at H h (f32 and sfu: the kernel's float32 and special-function
    operations a draw)."""
    nbytes = idx.numel() * 8 + out.numel() * 4
    classes = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "int32": (nz * h * DRAW_INT_OPS + idx.numel() * THREEFRY_INT_OPS)
        / INT32_OPS_PER_S * 1e3,
        "f32": nz * h * f32 / F32_OPS_PER_S * 1e3,
        "sfu": nz * h * sfu / SFU_PER_S * 1e3}
    by = max(classes, key=classes.get)
    return {"shape": list(idx.shape) + [h], "ms": ms,
            "device_method": method, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": classes[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_class": by, "bound_classes_ms": classes,
            "f32_only_bound_ms": max(classes["bytes"], classes["f32"]),
            "bytes_bound_ms": classes["bytes"], "in_band": in_band,
            "max_abs_err": err}


def k1_at(torch, L, key, idx, val, h, padded_b, route, device):
    """K1 at one of a path's shapes (idx/val on the card, signed as in a
    batch of padded_b): its bits equal the plain version's (raises
    otherwise), timed beside it; the report row (sig_variant)."""
    got = L.lsh_signature(key, idx, val, h, padded_b)
    ref = L.lsh_signature_ref(key, idx, val, h, padded_b)
    flip = nn_bits(torch, got, h) != nn_bits(torch, ref, h)
    if bool(flip.any()):
        raise AssertionError(f"{route}: K1 at B {idx.shape[0]} H {h}: "
                             f"{int(flip.sum())} bits differ from the plain "
                             "version's")
    ms, method, call_ms = nn_times(
        torch, lambda: L.lsh_signature(key, idx, val, h, padded_b), device,
        50)
    plain_ms = time_cuda(torch, lambda: L.lsh_signature_ref(
        key, idx, val, h, padded_b), 2) if device == "cuda" else None
    row = sig_variant(idx, int((val != 0).sum()), got, h, K1_F32_OPS,
                      K1_SFU_OPS, ms, method, call_ms, plain_ms, 0, 0.0)
    row["route"] = route
    return row


def phase_nn_kernels(torch, np, device="cuda"):
    """Phase 10a: the LSH kernels against their plain versions on the
    card.  The PRNG (fold_in keys, bits, both uniforms) of the plain
    version on the card bitwise its CPU run; K1 and K2 at B 1024, K 16, H
    64 and 512, at B 64 and at B 1, K 16, H 64, their signatures bitwise
    the plain versions' (in_band counts the differing bits or slots and
    must be 0); K3 at
    10^6 rows for lsh H 64, euclid_lsh H 512 and minhash H 64, with 1
    and 64 queries and by stored row: keys bitwise for lsh and minhash,
    euclid_lsh scores within rtol/atol 1e-6.  Each timed by CUDA events
    beside its plain version, its bound and, for the sweep, torch.topk
    over [R] float32 scores (the selection's yardstick).  Returns the
    kernels' rows."""
    from jubatus_tpu_torch.ops import lsh as L

    dev = torch.device(device)
    key = L.prng_key(0x1EAF)
    ids = torch.arange(0, 1 << 16, 7, dtype=torch.int32)
    for h in (64, 512):
        kc, kd = L.fold_in(key, ids), L.fold_in(key, ids.to(dev))
        bc, bd = L.random_bits(*kc, h), L.random_bits(*kd, h)
        if not (torch.equal(kc[0], kd[0].cpu()) and
                torch.equal(kc[1], kd[1].cpu()) and
                torch.equal(bc, bd.cpu())):
            raise AssertionError("nn: fold_in keys or bits differ between "
                                 "the card and the CPU")
        for lo in (L._MINHASH_LO, L._NORMAL_LO):
            uc = L.uniform_from_bits(bc, lo, 1.0)
            ud = L.uniform_from_bits(bd, lo, 1.0)
            if not torch.equal(uc.view(torch.int32),
                               ud.cpu().view(torch.int32)):
                raise AssertionError("nn: uniforms differ between the card "
                                     "and the CPU")
    rows = {}
    variants = {"lsh_signature": [], "minhash_signature": []}
    for h, b in ((64, NN_SIG_B), (512, NN_SIG_B), (64, 64), (64, 1)):
        idx, val = nn_sig_batch(torch, np, dev, h, b)
        nz = int((val != 0).sum())
        # K1 and K2: bitwise their plain versions (XLA's order, its log1p
        # and log, its fused steps and flushes in both)
        got = L.lsh_signature(key, idx, val, h)
        ref = L.lsh_signature_ref(key, idx, val, h)
        flip = nn_bits(torch, got, h) != nn_bits(torch, ref, h)
        gotm = L.minhash_signature(key, idx, val, h)
        refm = L.minhash_signature_ref(key, idx, val, h)
        moved = gotm != refm
        if bool(flip.any()) or bool(moved.any()):
            raise AssertionError(
                f"nn: B {b} H {h}: {int(flip.sum())} lsh_signature bits and "
                f"{int(moved.sum())} minhash_signature slots differ from "
                "the plain versions")
        # max_abs_err over the outputs' values: K1's bits, K2's slots
        # (feature indices); 0.0 where they equal the plain version's
        errs = {"lsh_signature": float(flip.any()),
                "minhash_signature": float(
                    (gotm.to(torch.int64) - refm.to(torch.int64)).abs()
                    .max()) if bool(moved.any()) else 0.0}
        for name, fn, refn, out, bad, f32, sfu in (
                ("lsh_signature", L.lsh_signature, L.lsh_signature_ref, got,
                 flip, K1_F32_OPS, K1_SFU_OPS),
                ("minhash_signature", L.minhash_signature,
                 L.minhash_signature_ref, gotm, moved, K2_F32_OPS,
                 K2_SFU_OPS)):
            ms, method, call_ms = nn_times(
                torch, lambda: fn(key, idx, val, h), device, 50)
            plain_ms = time_cuda(torch, lambda: refn(key, idx, val, h), 3) \
                if device == "cuda" else None
            # bits (K1) or slots (K2) that differ from the plain
            # version's: 0 (checked above)
            variants[name].append(sig_variant(
                idx, nz, out, h, f32, sfu, ms, method, call_ms, plain_ms,
                int(bad.sum()), errs[name]))
    for name, v in variants.items():
        main = v[0]                       # H 64: the service's table
        rows[name] = {**{k: main[k] for k in (
            "ms", "device_method", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "bytes_bound_ms", "shape", "in_band",
            "max_abs_err")}, "library_ms": None, "variants": v}
        log(f"nn kernels: {name}: " + "; ".join(
            f"B {x['shape'][0]} H {x['shape'][2]}: {x['ms']} ms (call "
            f"{x['call_ms']}, plain "
            f"{x['plain_ms']}, bound "
            f"{x['bound_ms']:.4g} by {x['bound_class']}), {x['in_band']} "
            "differing" for x in v))

    sweeps = []
    for kind, h in (("lsh", 64), ("euclid_lsh", 512), ("minhash", 64)):
        rng = np.random.default_rng(h + len(kind))
        r, w = NN_SWEEP_ROWS, L.sig_width(kind, h)
        if kind == "minhash":
            tab = torch.from_numpy(rng.integers(0, 8, (r, w), dtype=np.int32))
        else:
            tab = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (r, w),
                                                dtype=np.int64).astype(
                                                    np.int32))
        tab = tab.to(dev)
        norms = torch.from_numpy((rng.random(r) * 4).astype(np.float32)).to(
            dev)
        for nq in (1, 64):
            q_rows = torch.from_numpy(rng.integers(0, r, nq)).to(dev)
            qs, qn = tab[q_rows].contiguous(), norms[q_rows].contiguous()
            valid = r - 3
            sweeps.append(topk_row(torch, np, L, kind, h, tab, norms, valid,
                                   qs, qn, q_rows, "signature", device))
        del tab, norms
    rows["sig_topk_variants"] = sweeps
    log("nn kernels: sig_topk: " + "; ".join(
        f"{x['kind']} H {x['hash_num']} Nq {x['shape'][2]}: {x['ms']} ms "
        f"({x['device_method']}; call {x['call_ms']}, by row "
        f"{x['by_row_ms']}, plain {x['plain_ms']}, bound "
        f"{x['bound_ms']:.4g} by {x['bound_class']}, topk "
        f"{x['library_ms']}), bitwise" for x in sweeps))
    return rows


def topk_bound(kind, r, w, n_valid, nq, kb):
    """K3's least time in ms by class: the bytes it must move (the valid
    rows' signatures, and norms for euclid_lsh only, read once; the
    queries read once; the top keys written once) and the operations its
    scores need, each class at its own rate: per valid row and query W
    popcounts and 2 W integer operations (xor and add; minhash: W
    compares and W adds, no popcount) and, for euclid_lsh, the
    estimate's 8 float32 operations and its sqrt.  The selection's
    compares are not counted."""
    norms = n_valid * 4 if kind == "euclid_lsh" else 0
    nbytes = n_valid * w * 4 + norms + nq * (w * 4 + 4) + nq * kb * 8
    pairs = n_valid * nq
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "int32": pairs * 2 * w / INT32_OPS_PER_S * 1e3,
            "popc": (0 if kind == "minhash" else pairs * w) / POPC_PER_S
            * 1e3,
            "f32": (pairs * 8 if kind == "euclid_lsh" else 0)
            / F32_OPS_PER_S * 1e3,
            "sfu": (pairs if kind == "euclid_lsh" else 0) / SFU_PER_S * 1e3}


def topk_row(torch, np, L, kind, h, table, norms, n, qs, qn, q_rows, route,
             device, kb=NN_KB, mask=None):
    """K3 (the sweep with its top-kb selection, over the rows below n
    that the mask keeps) at one shape: by signature and, where q_rows
    names the rows qs holds, by stored row, both bitwise its plain
    version's (sig_sweep_ref, then torch.topk over the keys); the card's
    time (a CUDA graph at one query, CUDA events at more), the call's,
    the by-row call's and the plain version's; the bound by class (the
    mask's bytes too); torch.topk over [Nq, R] float32 scores as the
    selection's yardstick."""
    r, w = table.shape
    nq = qs.shape[0]

    def topk(**kw):
        return L.sig_topk(kind, table, norms, n, hash_num=h, kb=kb,
                          mask=mask, **kw)

    got = topk(q_sigs=qs, qnorms=qn)
    by_row = got if q_rows is None else topk(q_rows=q_rows)
    ref = L.sig_topk_ref(kind, table, norms, n, qs, qn, h, kb, mask)
    if not (torch.equal(got, ref) and torch.equal(by_row, ref)):
        raise AssertionError(f"nn: sig_topk {kind} H {h} Nq {nq} kb {kb} "
                             f"({route}): top keys differ from the plain "
                             "version's")
    del got, by_row, ref
    if nq == 1:
        ms, method, call_ms = nn_times(
            torch, lambda: topk(q_sigs=qs, qnorms=qn), device, 20)
    else:
        ms = time_cuda(torch, lambda: topk(q_sigs=qs, qnorms=qn), 20) \
            if device == "cuda" else None
        method, call_ms = "call", ms
    row_ms = time_cuda(torch, lambda: topk(q_rows=q_rows), 20) \
        if device == "cuda" and q_rows is not None else None
    plain_ms = time_cuda(torch, lambda: L.sig_topk_ref(
        kind, table, norms, n, qs, qn, h, kb, mask), 2) \
        if device == "cuda" else None
    # numpy's draws: an earlier phase's failed graph capture can leave
    # torch's CUDA generator unusable
    scores = torch.from_numpy(np.random.default_rng(r).random(
        (nq, r), dtype=np.float32)).to(table.device)
    lib_ms = (nn_times(torch, lambda: torch.topk(scores, kb), device,
                       20)[0] if nq == 1 else
              time_cuda(torch, lambda: torch.topk(scores, kb), 20)) \
        if device == "cuda" else None
    del scores
    classes = topk_bound(kind, r, w, n, nq, kb)
    if mask is not None:
        classes["bytes"] += n / HBM_BYTES_PER_S * 1e3
    by = max(classes, key=classes.get)
    return {
        "kind": kind, "hash_num": h, "route": route, "shape": [r, w, nq],
        "kb": kb, "valid_rows": n, "ms": ms, "device_method": method,
        "call_ms": call_ms, "by_row_ms": row_ms, "plain_ms": plain_ms,
        "bound_ms": classes[by],
        "bound_by": "bytes" if by == "bytes" else "operations",
        "bound_class": by, "bound_classes_ms": classes,
        "bytes_bound_ms": classes["bytes"], "library_ms": lib_ms,
        "plan": L.topk_plan(r, w, nq, kb, n, kind) if device == "cuda"
        else None, "keys_equal": 1.0, "max_abs_err": 0.0}


def nn_served_sweep(torch, np, drv, datum, row_id, device="cuda"):
    """K3 on a driver's own table at a read's query: one datum signed as
    similar_row_from_datum signs it, one stored row (the _from_id routes)
    and 64 stored rows (a lane sweep's), bitwise the plain version's
    (topk_row); and a datum read's
    device split: K1 at B 1, K3, the copy of its [1, NN_KB] keys out, and
    the whole fused_sig_query call."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.ops import lsh as L

    kind, h = drv.method, drv.hash_num
    table, norms, n = drv.sig, drv.norms, drv.pages.n_rows
    dev = table.device
    batch = drv.converter.convert_batch([nn_datum(Datum, datum)],
                                        update_weights=False)
    idx = L._host(batch.indices, np.int32, dev)
    val = L._host(batch.values, np.float32, dev)
    q_sig = L.signature(drv.key, idx, val, h, kind)
    qnorm = np.sqrt((batch.values * batch.values).sum(axis=1))
    q_norm = L._host(qnorm, np.float32, dev)
    q_row = torch.tensor([drv.ids[row_id]], dtype=torch.int64, device=dev)
    # a lane sweep's shape too: 64 stored rows at once
    q_rows = torch.arange(0, n, max(1, n // 64), dtype=torch.int64,
                          device=dev)[:64]
    out = [topk_row(torch, np, L, kind, h, table, norms, n, q_sig, q_norm,
                    None, "datum", device),
           topk_row(torch, np, L, kind, h, table, norms, n, table[q_row],
                    norms[q_row], q_row, "row", device),
           topk_row(torch, np, L, kind, h, table, norms, n, table[q_rows],
                    norms[q_rows], q_rows, "rows", device)]
    split = None
    if device == "cuda":
        keys = L.sig_topk(kind, table, norms, n, q_sigs=q_sig,
                          qnorms=q_norm, hash_num=h, kb=NN_KB)
        sig_ms = nn_times(torch, lambda: L.signature(drv.key, idx, val, h,
                                                     kind), device, 20)
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            L.fused_sig_query(kind, drv.key, batch.indices, batch.values,
                              table, norms, n, h, float(qnorm[0]), NN_SIZE)
        read_ms = (time.perf_counter() - t0) * 1e3 / reps
        split = {"signature_ms": sig_ms[0], "signature_method": sig_ms[1],
                 "signature_call_ms": sig_ms[2], "sig_topk_ms": out[0]["ms"],
                 "sig_topk_call_ms": out[0]["call_ms"],
                 "copy_out_ms": time_cuda(torch, lambda: keys.cpu(), 200),
                 "fused_sig_query_ms": read_ms}
    log("nn kernels: sig_topk on the served table: " + "; ".join(
        f"{x['route']} query at {x['shape']} ({x['valid_rows']} valid): "
        f"{x['ms']} ms ({x['device_method']}; call {x['call_ms']}, plain "
        f"{x['plain_ms']}, bound {x['bound_ms']:.4g} by "
        f"{x['bound_class']}, topk {x['library_ms']}), bitwise"
        for x in out) + f"; a datum read's device split {split}")
    return out, split


class counting_calls:
    """Within the block, torch.topk and the plain K3 (sig_topk_ref) count
    their calls into `counts` (keys "torch.topk", "sig_topk_ref")."""

    def __init__(self, torch, lshops, counts):
        self.torch, self.lshops, self.counts = torch, lshops, counts

    def __enter__(self):
        self.saved = (self.torch.topk, self.lshops.sig_topk_ref)

        def wrap(name, fn):
            def counted(*a, **kw):
                self.counts[name] += 1
                return fn(*a, **kw)
            return counted

        self.torch.topk = wrap("torch.topk", self.saved[0])
        self.lshops.sig_topk_ref = wrap("sig_topk_ref", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.torch.topk, self.lshops.sig_topk_ref = self.saved
        return False


def pct(np, xs, q):
    return float(np.percentile(xs, q)) if xs else None


def phase_nn_service(torch, np, card, device="cuda"):
    """Phase 10b: the service at full size.  A 10^6-row lsh table built in
    this process through set_row_many, NN_BATCH rows a call, saved in the
    port's model-file format and loaded over the wire by two port servers
    (--type nearest_neighbor), one with --read_batch_window_us 200.  The
    plain one takes NN_NEW set_row calls of new ids and NN_READS calls of
    each of the four reads at size NN_SIZE, every answer bitwise the
    in-process driver's; then LANE_THREADS client threads of one-datum
    similar_row_from_datum reads go to each server, every lane answer
    bitwise the read sent alone and the lane fusing (read_batch_size
    mean > 1); then similar_row_from_datum_many alone at B 1, 16 and 64
    (CUDA events); last, K3 against its plain version on a copy of the
    servers' table (the file's rows loaded, the new rows set: the
    servers' layout and slot count) at a datum and a by-row query, with
    a datum read's device split.  Every read sweeps through one K3
    launch: the in-process driver's reads launch it once each and call
    neither torch.topk nor a plain version; the plain server's launches
    equal its reads and the lane server's its read_batch_size count.
    Returns the launches of this path, the build's and the server
    processes', and that check's sig_topk rows and split."""
    import threading

    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.framework.save_load import save_model
    from jubatus_tpu_torch.framework.server_base import (USER_DATA_VERSION,
                                                         kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as lshops

    rng = np.random.default_rng(12)
    drv = create_driver("nearest_neighbor", NN_CONFIG, device=device)
    reset_kernel_launches()
    t0 = time.perf_counter()
    for start in range(0, NN_ROWS, NN_BATCH):
        n = min(NN_BATCH, NN_ROWS - start)
        drv.set_row_many([(f"r{start + i}", nn_datum(Datum, d))
                          for i, d in enumerate(nn_datums(np, rng, n))])
    if device == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = kernel_launches()
    t0 = time.perf_counter()
    pack = drv.pack()
    pack_s = time.perf_counter() - t0
    cfg_s = json.dumps(NN_CONFIG)
    fresh = nn_datums(np, rng, NN_NEW + NN_READS * 2)
    new_rows = fresh[:NN_NEW]
    queries = fresh[NN_NEW:]
    ids = [f"r{i}" for i in rng.integers(0, NN_ROWS, NN_READS * 2)]
    n_lane = LANE_THREADS * LANE_CALLS
    lane_q = [nn_wire(d) for d in nn_datums(np, rng, n_lane)]
    lat = {}
    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "nn.json")
        with open(cfg_path, "w") as f:
            f.write(cfg_s)
        try:
            started = {
                "plain": start_server("nearest_neighbor", cfg_path, tmp,
                                      device=device),
                "lane": start_server("nearest_neighbor", cfg_path, tmp,
                                     "--read_batch_window_us",
                                     str(LANE_WINDOW_US), device=device)}
            children += [c for c, _ in started.values()]
            ports = {k: server_ready(*v)[0] for k, v in started.items()}
            t0 = time.perf_counter()
            for k, port in ports.items():
                path = os.path.join(
                    tmp, f"127.0.0.1_{port}_jubatus_nearest_neighbor__nn"
                    ".jubatus")
                with open(path, "wb") as f:
                    save_model(f, server_type="nearest_neighbor",
                               model_id="nn", config=cfg_s,
                               user_data_version=USER_DATA_VERSION,
                               driver_data=pack)
            save_s = time.perf_counter() - t0
            load_ms = {}
            for k, port in ports.items():
                cli = WireClient(port)
                t0 = time.perf_counter()
                if cli.call("load", "nn") is not True:
                    raise AssertionError(f"nn: the {k} server did not load")
                load_ms[k] = (time.perf_counter() - t0) * 1e3
                cli.close()
            cli = WireClient(ports["plain"])
            t_set = []
            for i, d in enumerate(new_rows):
                t0 = time.perf_counter()
                if cli.call("set_row", f"n{i}", nn_wire(d)) is not True:
                    raise AssertionError("nn: a set_row was not acknowledged")
                t_set.append((time.perf_counter() - t0) * 1e3)
            for i, d in enumerate(new_rows):
                drv.set_row(f"n{i}", nn_datum(Datum, d))
            answers = {}
            local = {"reads": 0, "torch.topk": 0, "sig_topk_ref": 0}
            n0 = lshops.sig_topk.launches
            for method in ("similar_row_from_datum", "neighbor_row_from_datum",
                           "similar_row_from_id", "neighbor_row_from_id"):
                args = ([nn_wire(q) for q in queries[:NN_READS]]
                        if method.endswith("datum") else ids[:NN_READS])
                if method.startswith("neighbor"):
                    args = ([nn_wire(q) for q in queries[NN_READS:]]
                            if method.endswith("datum") else ids[NN_READS:])
                lat[method], answers[method] = [], []
                for a in args:
                    t0 = time.perf_counter()
                    answers[method].append(cli.call(method, a, NN_SIZE))
                    lat[method].append((time.perf_counter() - t0) * 1e3)
                for a, got in zip(args, answers[method]):
                    x = (Datum.from_msgpack(a) if method.endswith("datum")
                         else a)
                    with counting_calls(torch, lshops, local):
                        want = [[i, s] for i, s in getattr(drv, method)(
                            x, NN_SIZE)]
                    local["reads"] += 1
                    if got != want:
                        raise AssertionError(f"nn: {method} over the wire "
                                             "differs from the in-process "
                                             "driver")
            st_plain = status_of(cli)
            cli.close()
            local["sig_topk"] = lshops.sig_topk.launches - n0
            if device == "cuda" and (
                    local["sig_topk"] != local["reads"]
                    or local["torch.topk"] or local["sig_topk_ref"]):
                raise AssertionError(f"nn: the in-process reads {local}: "
                                     "not one K3 launch each, or a "
                                     "torch.topk or plain-version call")
            if int(st_plain["num_rows"]) != NN_ROWS + NN_NEW:
                raise AssertionError(f"nn: the server holds "
                                     f"{st_plain['num_rows']} rows")
            lane = {}
            for k in ("lane", "plain"):
                la, ans = [0.0] * n_lane, [None] * n_lane

                def reads(idx, k=k, la=la, ans=ans):
                    c = WireClient(ports[k])
                    try:
                        for i in idx:
                            t0 = time.perf_counter()
                            ans[i] = c.call("similar_row_from_datum",
                                            lane_q[i], NN_SIZE)
                            la[i] = (time.perf_counter() - t0) * 1e3
                    finally:
                        c.close()

                threads = [threading.Thread(
                    target=reads, args=(range(t, n_lane, LANE_THREADS),))
                    for t in range(LANE_THREADS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                if any(t.is_alive() for t in threads) or None in ans:
                    raise AssertionError("nn: a read-lane client thread did "
                                         "not finish")
                lane[k] = (la, ans)
            cli = WireClient(ports["lane"])
            lane_st = status_of(cli)
            alone = [cli.call("similar_row_from_datum", q, NN_SIZE)
                     for q in lane_q]
            cli.close()
            served_launches, final = {}, {}
            for k, port in ports.items():
                cli = WireClient(port)
                final[k] = status_of(cli)
                for kern, c in launches_of(final[k]).items():
                    served_launches[kern] = served_launches.get(kern, 0) + c
                cli.close()
        finally:
            for ch in children:
                ch.stop()
    if lane["lane"][1] != alone:
        bad = sum(a != b for a, b in zip(lane["lane"][1], alone))
        raise AssertionError(f"nn: {bad} of {n_lane} lane answers differ "
                             "from the read sent alone")
    mean = float(lane_st["read_batch_size_mean"])
    if not mean > 1.0:
        raise AssertionError(f"nn: read_batch_size mean {mean}: the lane "
                             "fused no reads")
    # one K3 launch a read (plain server) and a lane sweep (lane server)
    sweeps = {"plain": {"reads": 4 * NN_READS + n_lane},
              "lane": {"reads": int(final["lane"]["read_batch_size_count"])}}
    for k in sweeps:
        sweeps[k]["sig_topk"] = launches_of(final[k]).get("sig_topk", 0)
        if device == "cuda" and sweeps[k]["sig_topk"] != sweeps[k]["reads"]:
            raise AssertionError(f"nn: the {k} server launched K3 "
                                 f"{sweeps[k]['sig_topk']} times for "
                                 f"{sweeps[k]['reads']} reads")
    # the table the servers sweep: loading sizes the store to the file,
    # the new rows then double its pages
    served = create_driver("nearest_neighbor", NN_CONFIG, device=device)
    served.unpack(pack)
    served.set_row_many([(f"n{i}", nn_datum(Datum, d))
                         for i, d in enumerate(new_rows)])
    slots = int(st_plain["pages"]) * int(st_plain["page_rows"])
    if served.pages.capacity != slots:
        raise AssertionError(f"nn: the copy of the servers' table has "
                             f"{served.pages.capacity} slots, the servers "
                             f"{slots}")
    served_sweeps, read_split = nn_served_sweep(torch, np, served,
                                                queries[0], ids[0], device)
    del served
    many_ms = {}
    for b in (1, 16, 64):
        pairs = [(Datum.from_msgpack(q), NN_SIZE) for q in lane_q[:b]]
        if device == "cuda":
            many_ms[b] = time_cuda(
                torch, lambda: drv.similar_row_from_datum_many(pairs), 20)
    counts = {k: build.get(k, 0) + served_launches.get(k, 0)
              for k in ("lsh_signature", "minhash_signature", "sig_topk")}
    line = {
        "rows": NN_ROWS + NN_NEW, "hash_num": 64,
        "build_rows_per_s": NN_ROWS / build_s, "build_s": build_s,
        "build_launches": {k: build[k] for k in ("lsh_signature",
                                                 "sig_topk")},
        "pack_s": pack_s, "save_s": save_s, "load_ms": load_ms,
        "set_row_ms_p50": pct(np, t_set, 50),
        "set_row_ms_p99": pct(np, t_set, 99),
        **{f"{m}_ms_p50": pct(np, v, 50) for m, v in lat.items()},
        **{f"{m}_ms_p99": pct(np, v, 99) for m, v in lat.items()},
        "lane": {"threads": LANE_THREADS, "calls": n_lane,
                 "window_us": LANE_WINDOW_US,
                 "p50_ms": {k: pct(np, v[0], 50) for k, v in lane.items()},
                 "p99_ms": {k: pct(np, v[0], 99) for k, v in lane.items()},
                 "read_batch_size_mean": mean,
                 "read_batch_size_max": float(
                     lane_st["read_batch_size_max"])},
        "similar_row_from_datum_many_ms": many_ms,
        "read_split": read_split, "local_reads": local,
        "reads_and_sweeps": sweeps,
        "server_launches": served_launches, "card": card}
    log(f"nn service: {NN_ROWS} rows built at "
        f"{line['build_rows_per_s']:.0f} rows/s, loaded by two servers; "
        f"{NN_NEW} set_row and 4 x {NN_READS} reads over the wire bitwise "
        f"the in-process driver's; {n_lane} lane reads bitwise the reads "
        f"sent alone, read_batch_size mean {mean:.2f}")
    log("nn_service " + json.dumps(line))
    return counts, served_sweeps


def nn_table(np, pack):
    """A driver's pack as {id: (signature bytes, norm bits)}."""
    cap, h = int(pack["capacity"]), int(pack["hash_num"])
    method = pack["method"]
    w = h if (method if isinstance(method, str)
              else method.decode()) == "minhash" else (h + 31) // 32
    sig = np.frombuffer(pack["sig"], np.uint32).reshape(cap, w)
    norms = np.frombuffer(pack["norms"], np.uint32)
    return {(r if isinstance(r, str) else r.decode()):
            (sig[i].tobytes(), int(norms[i]))
            for i, r in enumerate(pack["row_ids"])}


NN_CLUSTER_METHODS = {"lsh": "lsh_signature", "minhash": "minhash_signature"}


def phase_nn_cluster(torch, np, card, device="cuda"):
    """Phase 10c: MIX and recovery, for lsh and for minhash (hash_num 64)
    at once.  The port's coordinator and, per method, two port
    nearest_neighbor servers (--mix_quantize, a trigger out of reach,
    each with its own --journal and no snapshot timer) as subprocesses;
    each server gets NN_CLUSTER_ROWS set_row calls over the wire (one id
    on both), then do_mix: both tables bitwise equal, and equal to a
    driver here that applied the rows in the master's member order; a
    second do_mix changes nothing.  Server 1 of each is SIGKILLed and
    restarted on its directory: it must come back bitwise, having
    replayed its "u" records through its signature kernel (launched in
    the new process) and its "diff" records.  Returns the server
    processes' launches."""
    import threading

    from jubatus_tpu_torch.cluster.membership import MembershipClient
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.mix import codec
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.rpc.client import Client

    methods = list(NN_CLUSTER_METHODS)
    cfgs = {m: dict(NN_CONFIG, method=m) for m in methods}
    rng = np.random.default_rng(13)
    own = {}
    for m in methods:
        own[m] = [[(f"s{s}_{i}", d) for i, d in enumerate(
            nn_datums(np, rng, NN_CLUSTER_ROWS))] for s in range(2)]
        own[m][1][-1] = ("s0_0", own[m][1][-1][1])  # an id written on both

    def table_of(port):
        with Client("127.0.0.1", port, timeout=600) as c:
            return nn_table(np, codec.decode(c.call_raw("get_model",
                                                        0))["model"])

    def each(fn, args):
        """fn(*a) for every a at once, on threads; their results."""
        out = [None] * len(args)
        errs = []

        def run(i, a):
            try:
                out[i] = fn(*a)
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i, a))
                   for i, a in enumerate(args)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errs:
            raise errs[0]
        if any(t.is_alive() for t in threads):
            raise AssertionError("nn cluster: a worker thread hung")
        return out

    children = []
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            coord = Child(["jubatus_tpu_torch.cluster.coordinator",
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1"])
            children.append(coord)
            addr = coord.wait_line("jubacoordinator", 120).split()[-1]
            argv, servers = {}, {}
            for m in methods:
                cfg_path = os.path.join(tmp, f"nn_{m}.json")
                with open(cfg_path, "w") as f:
                    json.dump(cfgs[m], f)
                argv[m] = [[
                    "jubatus_tpu_torch.cli.server", "--type",
                    "nearest_neighbor", "--configpath", cfg_path, "--name",
                    f"smoke_nn_{m}", "--rpc-port", "0", "--listen_addr",
                    "127.0.0.1", "--eth", "127.0.0.1", "--datadir", tmp,
                    "--device", device, "--coordinator", addr,
                    "--mix_quantize", "--interval_sec", "100000",
                    "--interval_count", "100000000",
                    "--journal", os.path.join(tmp, f"dur_{m}{i}"),
                    "--journal_fsync", "batch", "--snapshot_interval", "0"]
                    for i in range(2)]
                servers[m] = [Child(a) for a in argv[m]]
                children.extend(servers[m])
            ports = {m: [int(s.wait_line("jubatus ready", 300).split()[2]
                             .split("=")[1]) for s in servers[m]]
                     for m in methods}
            order = {}
            for m in methods:
                membership = MembershipClient(addr, "nearest_neighbor",
                                              f"smoke_nn_{m}")
                deadline = time.monotonic() + 60
                while set(membership.get_all_nodes()) != \
                        {("127.0.0.1", p) for p in ports[m]}:
                    if time.monotonic() > deadline:
                        raise AssertionError(f"nn cluster {m}: both servers "
                                             "never listed in get_all_nodes")
                    time.sleep(0.1)
                order[m] = [ports[m].index(p)
                            for _, p in membership.get_all_nodes()]
                membership.close()

            def feed(m, s):
                c = WireClient(ports[m][s])
                for rid, d in own[m][s]:
                    if c.call("set_row", rid, nn_wire(d)) is not True:
                        raise AssertionError(f"nn cluster {m}: a set_row "
                                             "was not acknowledged")
                c.close()

            t0 = time.perf_counter()
            each(feed, [(m, s) for m in methods for s in range(2)])
            feed_s = time.perf_counter() - t0

            def mix(m):
                cli = WireClient(ports[m][0])
                t0 = time.perf_counter()
                if cli.call("do_mix") is not True:
                    raise AssertionError(f"nn cluster {m}: do_mix failed")
                ms = (time.perf_counter() - t0) * 1e3
                tables = [table_of(p) for p in ports[m]]
                st = status_of(cli)
                cli.close()
                cli = WireClient(ports[m][1])
                if cli.call("do_mix") is not True:
                    raise AssertionError(f"nn cluster {m}: the second "
                                         "do_mix failed")
                cli.close()
                if [table_of(p) for p in ports[m]] != tables:
                    raise AssertionError(f"nn cluster {m}: the second do_mix "
                                         "moved a table")
                statuses = []
                for p in ports[m]:
                    cli = WireClient(p)
                    statuses.append(status_of(cli))
                    cli.close()
                servers[m][1].kill()
                t0 = time.perf_counter()
                servers[m][1] = Child(argv[m][1])
                children.append(servers[m][1])
                port1 = int(servers[m][1].wait_line("jubatus ready", 300)
                            .split()[2].split("=")[1])
                reboot_ms = (time.perf_counter() - t0) * 1e3
                cli = WireClient(port1)
                restarted = status_of(cli)
                cli.close()
                return {"do_mix_ms": ms, "tables": tables, "status": st,
                        "statuses": statuses, "restarted": restarted,
                        "reboot_ms": reboot_ms,
                        "recovered": table_of(port1)}

            res = dict(zip(methods, each(mix, [(m,) for m in methods])))
        finally:
            for ch in children:
                ch.stop()
    launches = {}
    lines = {}
    for m in methods:
        r = res[m]
        ref = create_driver("nearest_neighbor", cfgs[m], device=device)
        for s in order[m]:
            ref.set_row_many([(rid, nn_datum(Datum, d))
                              for rid, d in own[m][s]])
        want = nn_table(np, ref.pack())
        tables = r["tables"]
        if not tables[0] == tables[1] == want:
            raise AssertionError(f"nn cluster {m}: the tables after do_mix "
                                 "differ from each other or from the union "
                                 "applied in the master's order")
        if len(want) != 2 * NN_CLUSTER_ROWS - 1:
            raise AssertionError(f"nn cluster {m}: {len(want)} rows in the "
                                 "union")
        if r["recovered"] != tables[1]:
            raise AssertionError(f"nn cluster {m}: the restarted server's "
                                 "table differs from its table before the "
                                 "kill")
        rs = r["restarted"]
        got = launches_of(rs)
        kern = NN_CLUSTER_METHODS[m]
        if rs["recovery_errors"] != "0" or \
                int(rs["recovery_replayed"]) < NN_CLUSTER_ROWS + 1 or \
                (device == "cuda" and got[kern] <= 0):
            raise AssertionError(f"nn cluster {m}: the restarted server "
                                 f"replayed {rs['recovery_replayed']} records "
                                 f"with {rs['recovery_errors']} errors and "
                                 f"{got[kern]} {kern} launches")
        for st in r["statuses"] + [rs]:
            for k, n in launches_of(st).items():
                launches[k] = launches.get(k, 0) + n
        st = r["status"]
        lines[m] = {
            "rows_per_server": NN_CLUSTER_ROWS, "do_mix_ms": r["do_mix_ms"],
            "last_mix_sec": float(st["last_mix_sec"]),
            "last_mix_wire_bytes": int(st["last_mix_wire_bytes"]),
            "mix_wire_version": st["mix_wire_version"],
            "restart": {"boot_to_routable_ms": r["reboot_ms"],
                        "recovery_replayed": int(rs["recovery_replayed"]),
                        "recovery_replay_ms": float(
                            rs["recovery_replay_ms"]),
                        "launches": got}}
        log(f"nn cluster: {m}: two servers' tables bitwise equal to the "
            f"union in the master's order ({len(want)} rows); the second "
            f"do_mix changed nothing; server 1 SIGKILLed and recovered "
            f"bitwise from {rs['recovery_replayed']} journal records "
            f"({got[kern]} {kern} launches)")
    log("nn_cluster " + json.dumps({"feed_s": feed_s, **lines,
                                    "card": card}))
    return launches

# ---------------------------------------------------------------------------
# 11. the recommender, anomaly and the NN classifier: K4 (dense_topk,
#     dense_dots), K5 (sig_counts) and K3 with a validity mask
# ---------------------------------------------------------------------------

RECO_CONFIG = {         # bench.py:156-163
    "method": "lsh", "parameter": {"hash_num": 128},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 1 << 16},
}
RECO_EXACT_CONFIG = {   # the exact sweep's table: 16 numeric features
    "method": "inverted_index", "parameter": {},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 4096},
}
LOF_CONFIG = {          # bench.py:824-831
    "method": "lof",
    "parameter": {"nearest_neighbor_num": 10,
                  "reverse_nearest_neighbor_num": 30,
                  "method": "euclid_lsh", "parameter": {"hash_num": 64}},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 1 << 16},
}
LOF_EXACT_CONFIG = dict(LOF_CONFIG, parameter=dict(
    LOF_CONFIG["parameter"], method="inverted_index_euclid"))
NNC_CONFIG = {          # method NN on bench.py's converter
    "method": "NN",
    "parameter": {"method": "euclid_lsh", "parameter": {"hash_num": 64},
                  "nearest_neighbor_num": 128},
    "converter": SERVER_CONFIG["converter"],
}
RECO_ROWS = 8192        # update_row calls over the wire
RECO_EXACT_ROWS = 10 ** 6
RECO_DROPS = 64         # clear_row calls: holes in the store's mask
RECO_READS = 64         # similar_row_from_datum calls
ANOM_ADDS = 1024        # add calls over the wire (16,384 before phase
#                         12: the whole smoke then ran past 800 s, with
#                         those adds taking 130-185 s of it; 8,192 until
#                         phase 13 came, 67 s of the smoke's 836; 4,096
#                         until phase 15 came, 2,048 until phase 16)
LOF_ROWS = 16384        # rows of K5's LOF-table shapes (phase 11a)
ANOM_TIMED = 512        # of them sent alone, their wire time kept
ANOM_EXACT_ADDS = 1024  # adds of the exact LOF in process (K4 dense_dots)
ANOM_READS = 64         # calc_score calls
NNC_TRAINS = 4          # train requests of NNC_B datums
NNC_B = 2048
NNC_READS = 32          # classify requests of 8 datums


def row_datums(np, rng, n, keys, nnz=16):
    """n datums of nnz distinct numeric features of `keys` names, standard
    normal values: (names, values) lists."""
    out = []
    for _ in range(n):
        ks = rng.choice(keys, nnz, replace=False)
        out.append(([f"f{k}" for k in ks.tolist()],
                    rng.standard_normal(nnz).tolist()))
    return out


def kernel_row(torch, fn, ref, device, plain_reps, lib=None,
               classes=None, shape=None, err=None, lib_calls=None):
    """One kernel's report row: fn's device ms (a CUDA graph where it
    captures), its call ms, the plain version's ms (`ref` on the same
    card tensors), the library call's (lib_calls: that many calls in the
    graph and no eager timing, for a slow call), and the bound by
    class."""
    ms, method, call_ms = nn_times(torch, fn, device, 20)
    plain_ms = time_cuda(torch, ref, plain_reps) if device == "cuda" \
        else None
    lib_ms = None
    if lib is not None and device == "cuda":
        lib_ms = (nn_times(torch, lib, device, 20)[0] if lib_calls is None
                  else time_device(torch, lib, lib_calls)[0])
    by = max(classes, key=classes.get)
    return {"ms": ms, "device_method": method, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": classes[by],
            "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_classes_ms": classes, "bytes_bound_ms": classes["bytes"],
            "shape": shape, "max_abs_err": err}


# K4's design, named in the kernels line
K4_DESIGN = ("persistent blocks; a producer warp streams tiles of 16-128 "
             "rows into a 3-4 stage cp.async ring with mbarriers; 4 "
             "consumer warps, a lane a row")


def one_launch(fn, *args):
    """fn(*args), checked on the card to launch its kernel once (the
    wrapper's count, fn.launches)."""
    n0 = fn.launches
    out = fn(*args)
    if out.device.type == "cuda" and fn.launches != n0 + 1:
        raise AssertionError(f"{fn.__name__}: {fn.launches - n0} launches "
                             "for one call")
    return out


def sparse_rows(torch, np, dev, r, kr, d, seed, nnz=16):
    """A sparse row table [r, kr] of nnz features a row (the rest
    padding) and its norms, as the stores hold them."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((r, kr), np.int32)
    val = np.zeros((r, kr), np.float32)
    idx[:, :nnz] = rng.integers(0, d, (r, nnz))
    val[:, :nnz] = rng.standard_normal((r, nnz))
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (idx, val, norms)]


def gathered_query_bytes(torch, idx, nq):
    """The bytes of nq dense queries that a sweep of the table idx must
    read: the entries at its distinct indices, not the whole query."""
    return nq * torch.unique(idx).numel() * 4


# K5's design, named in the kernels line
K5_DESIGN = ("the table read once for all queries; up to 16 words a row "
             "a thread a row read straight from device memory, the queries "
             "through L1, tiles of 32-256 rows (small tables: 2-8 threads "
             "share a row's queries); wider rows a producer warp's 3-4 "
             "stage cp.async ring with mbarriers, 8 consumer warps, 2-32 "
             "lanes a row, queries staged in shared memory (32 KB a group)")


def counts_bound(kind, r, w, nq):
    """K5's least time in ms by class: the table, its norms (euclid_lsh
    only) and the queries read once and [nq, r] written once; per pair W
    popcounts (not minhash) and 2 W int32 operations (xor or compare, and
    add); euclid_lsh's 8 float32 operations and sqrt a pair."""
    euclid = kind == "euclid_lsh"
    nbytes = (r * w * 4 + (r * 4 if euclid else 0) + nq * (w * 4 + 4)
              + nq * r * 4)
    pairs = r * nq
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "int32": pairs * 2 * w / INT32_OPS_PER_S * 1e3,
            "popc": (0 if kind == "minhash" else pairs * w) / POPC_PER_S
            * 1e3,
            "f32": (pairs * 8 if euclid else 0) / F32_OPS_PER_S * 1e3,
            "sfu": (pairs if euclid else 0) / SFU_PER_S * 1e3}


def cdist_layout(torch, kind, h, x):
    """torch.cdist(p=0)'s layout of signatures x [n, W] (K5's library
    yardstick): the H signature bits as float32 (lsh, euclid_lsh; the
    distance is the hamming count), the H words as float64 (minhash: H
    minus the matches)."""
    if kind == "minhash":
        return x.double()
    sh = torch.arange(32, device=x.device, dtype=torch.int64)
    v = x.to(torch.int64) & 0xFFFFFFFF
    return ((v[..., None] >> sh) & 1).reshape(
        x.shape[0], -1)[:, :h].float().contiguous()


def counts_rows(torch, np, L, dev, device, kind, h, r, nqs):
    """K5 at r rows of one kind for each query count in nqs: a seeded
    table (minhash words in 0..4), built once and freed after; nq queries
    drawn from it, one launch a call, bitwise its plain version; timed
    beside torch.cdist(p=0) over the bits as float32 (lsh, euclid_lsh) or
    the words as float64 (minhash), laid out before the timing, and the
    bound by class."""
    w = L.sig_width(kind, h)
    rg = np.random.default_rng(r + h)
    tab = rg.integers(0, 2 ** 32, (r, w), dtype=np.uint32)
    if kind == "minhash":
        tab %= 5
    tab = torch.from_numpy(tab.view(np.int32)).to(dev)
    n3 = torch.from_numpy((rg.random(r) * 4).astype(np.float32)).to(dev)
    xr = cdist_layout(torch, kind, h, tab) if device == "cuda" else None
    out = []
    for nq in nqs:
        pick = torch.from_numpy(rg.integers(0, r, nq)).to(dev)
        qs3 = tab[pick].clone()
        qs3[:, 0] ^= 3
        qn3 = n3[pick].clone()
        got = one_launch(L.sig_counts, kind, tab, qs3, n3, qn3, h)
        ref = L.sig_counts_ref(kind, tab, qs3, n3, qn3, h)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"rows: sig_counts {kind} H {h} at {r} "
                                 f"rows, {nq} queries differs from its "
                                 "plain version")
        lib = None
        if device == "cuda":
            xq = cdist_layout(torch, kind, h, qs3)

            def lib(xq=xq):
                return torch.cdist(xq, xr, p=0)
        row = kernel_row(
            torch, lambda: L.sig_counts(kind, tab, qs3, n3, qn3, h),
            lambda: L.sig_counts_ref(kind, tab, qs3, n3, qn3, h), device, 2,
            lib=lib, lib_calls=2, classes=counts_bound(kind, r, w, nq),
            shape=[r, w, nq], err=0.0)
        row.update(kind=kind, hash_num=h, plan=L.sig_counts_plan(
            kind, r, h, nq, table_ptr=tab.data_ptr()) if device == "cuda"
            else None, library="torch.cdist(p=0)")
        out.append(row)
    del tab, n3, xr
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_row_kernels(torch, np, device="cuda"):
    """Phase 11a: K4 dense_topk at the exact recommender's table (10^6
    rows, Kr 32, D 4096, 1% holes in the mask, kb 16, and kb 2048 on the
    sort path), K4 dense_dots at
    the exact LOF's sweep (its table after ANOM_EXACT_ADDS adds: Kr 32, D
    2^16, one query), at a 64-row LOF table and at 10^6 rows (K4 one
    launch a call, by the wrappers' counts), K5 sig_counts at the LOF table's
    sweep (euclid_lsh H 64, LOF_ROWS rows, one query) and at LOF_ROWS
    and 10^6 rows of euclid_lsh and lsh H 64, lsh H 512 and minhash H 64
    at one and 64 queries (one launch a call), and K3 with a mask at the
    recommender's
    lsh H 128 table: each bitwise its plain version on the same card
    tensors, timed beside it, beside its library yardstick (torch.topk of
    the scores for dense_topk and masked K3, torch.sparse.mm of the table
    as CSR for dense_dots, torch.cdist(p=0) for sig_counts but at the LOF
    table) and its bound."""
    from jubatus_tpu_torch.ops import lsh as L
    dev = torch.device(device)
    rows = {}
    rng = np.random.default_rng(21)
    # dense_topk
    r, kr, d, kb = RECO_EXACT_ROWS, 32, 4096, 16
    idx, val, norms = sparse_rows(torch, np, dev, r, kr, d, 22)
    mask = torch.from_numpy(rng.random(r) >= 0.01).to(dev)
    q = torch.from_numpy(rng.standard_normal((1, d)).astype(
        np.float32)).to(dev)
    qn = torch.sqrt((q * q).sum(1))
    variants = []
    for metric in ("cosine", "euclid"):
        got = one_launch(L.dense_topk, metric, idx, val, norms, r, mask, q,
                         qn, kb)
        ref = L.dense_topk_ref(metric, idx, val, norms, r, mask, q, qn, kb)
        if not torch.equal(got, ref):
            raise AssertionError(f"rows: dense_topk {metric} differs from "
                                 "its plain version")
        scores = torch.from_numpy(np.random.default_rng(1).random(
            (1, r), dtype=np.float32)).to(dev)
        nbytes = (r * kr * 8 + r * 4 + r + gathered_query_bytes(torch, idx, 1)
                  + 4 + kb * 8)
        row = kernel_row(
            torch,
            lambda m=metric: L.dense_topk(m, idx, val, norms, r, mask, q,
                                          qn, kb),
            lambda m=metric: L.dense_topk_ref(m, idx, val, norms, r, mask,
                                              q, qn, kb),
            device, 1, lib=lambda: torch.topk(scores, kb),
            classes={"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "f32": r * kr * 2 / F32_OPS_PER_S * 1e3},
            shape=[r, kr, d, 1, kb], err=0.0)
        row["metric"] = metric
        variants.append(row)
        del scores
    # a read of more rows than K3's lists hold (kb 2048): the sort path
    kb2 = 2048
    got = one_launch(L.dense_topk, "cosine", idx, val, norms, r, mask, q,
                     qn, kb2)
    if not torch.equal(got, L.dense_topk_ref("cosine", idx, val, norms, r,
                                             mask, q, qn, kb2)):
        raise AssertionError("rows: dense_topk at kb 2048 differs from its "
                             "plain version")
    scores = torch.from_numpy(np.random.default_rng(1).random(
        (1, r), dtype=np.float32)).to(dev)
    nbytes = (r * kr * 8 + r * 4 + r + gathered_query_bytes(torch, idx, 1)
              + 4 + kb2 * 8)
    row = kernel_row(
        torch, lambda: L.dense_topk("cosine", idx, val, norms, r, mask, q,
                                    qn, kb2),
        lambda: L.dense_topk_ref("cosine", idx, val, norms, r, mask, q, qn,
                                 kb2),
        device, 1, lib=lambda: torch.topk(scores, kb2),
        classes={"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "f32": r * kr * 2 / F32_OPS_PER_S * 1e3},
        shape=[r, kr, d, 1, kb2], err=0.0)
    row["metric"] = "cosine"
    variants.append(row)
    del scores
    rows["dense_topk"] = dict(variants[0], variants=variants[1:],
                              design=K4_DESIGN)
    # dense_dots: the exact LOF's sweep, a small LOF table (a tile of 16
    # rows on each of 4 blocks), then 10^6 rows
    variants = []
    for r2, d2 in ((ANOM_EXACT_ADDS, 1 << 16), (64, 1 << 16),
                   (RECO_EXACT_ROWS, 4096)):
        i2, v2, _ = sparse_rows(torch, np, dev, r2, kr, d2, 23)
        q2 = torch.from_numpy(np.random.default_rng(r2).standard_normal(
            (1, d2)).astype(np.float32)).to(dev)
        got = one_launch(L.dense_dots, i2, v2, q2)
        ref = L.dense_dots_ref(i2, v2, q2)
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError("rows: dense_dots differs from its plain "
                                 "version")
        crow = torch.arange(0, r2 * kr + 1, kr, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # CSR's beta notice
            csr = torch.sparse_csr_tensor(crow, i2.reshape(-1).long(),
                                          v2.reshape(-1), (r2, d2),
                                          check_invariants=False)
        qt = q2.T.contiguous()
        nbytes = r2 * kr * 8 + gathered_query_bytes(torch, i2, 1) + r2 * 4
        variants.append(kernel_row(
            torch, lambda: L.dense_dots(i2, v2, q2),
            lambda: L.dense_dots_ref(i2, v2, q2), device, 1,
            lib=lambda: torch.sparse.mm(csr, qt),
            classes={"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "f32": r2 * kr * 2 / F32_OPS_PER_S * 1e3},
            shape=[r2, kr, d2, 1], err=0.0))
        del i2, v2, csr
    rows["dense_dots"] = dict(variants[0], variants=variants[1:],
                              design=K4_DESIGN + "; 8 lanes a row at Kr 32")
    # sig_counts: the LOF table's sweep first, then each kind at the LOF
    # table's rows and 10^6 rows, one and 64 queries, beside torch.cdist
    t0 = time.perf_counter()
    variants = [row
                for kind, h in (("euclid_lsh", 64), ("lsh", 64), ("lsh", 512),
                                ("minhash", 64))
                for r3 in (LOF_ROWS, RECO_EXACT_ROWS)
                for row in counts_rows(torch, np, L, dev, device, kind, h,
                                       r3, (1, 64))]
    log(f"rows: sig_counts's {len(variants)} shapes checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    rows["sig_counts"] = dict(variants[0], variants=variants[1:],
                              design=K5_DESIGN)
    # K3 with a mask: the recommender's lsh H 128 table at 10^6 rows
    h, w = 128, 4
    rg = np.random.default_rng(24)
    tab = torch.from_numpy(rg.integers(0, 2 ** 32, (r, w), dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(dev)
    n4 = torch.zeros(r, dtype=torch.float32, device=dev)
    qs4 = tab[7:8].clone()
    qn4 = n4[7:8].clone()
    got = L.sig_topk("lsh", tab, n4, r, q_sigs=qs4, qnorms=qn4, hash_num=h,
                     kb=kb, mask=mask)
    ref = L.sig_topk_ref("lsh", tab, n4, r, qs4, qn4, h, kb, mask)
    if not torch.equal(got, ref):
        raise AssertionError("rows: masked sig_topk differs from its plain "
                             "version")
    scores = torch.from_numpy(np.random.default_rng(2).random(
        (1, r), dtype=np.float32)).to(dev)
    classes = topk_bound("lsh", r, w, r, 1, kb)
    classes["bytes"] += r / HBM_BYTES_PER_S * 1e3          # the mask
    rows["sig_topk_masked"] = kernel_row(
        torch, lambda: L.sig_topk("lsh", tab, n4, r, q_sigs=qs4,
                                      qnorms=qn4, hash_num=h, kb=kb,
                                      mask=mask),
        lambda: L.sig_topk_ref("lsh", tab, n4, r, qs4, qn4, h, kb, mask),
        device, 1, lib=lambda: torch.topk(scores, kb), classes=classes,
        shape=[r, w, 1, kb], err=0.0)
    for name in ("dense_topk", "dense_dots", "sig_counts", "sig_topk_masked"):
        rr = rows[name]
        log(f"rows: {name} {rr['ms']} ms at {rr['shape']} (plain "
            f"{rr['plain_ms']} ms, library {rr['library_ms']} ms, bound "
            f"{rr['bound_ms']:.4g} ms by {rr['bound_by']})")
    return rows


def launch_counts():
    from jubatus_tpu_torch.framework.server_base import kernel_launches
    return kernel_launches()


def launch_delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def check_reads(what, delta, reads, kern):
    """Every read launched `kern` once."""
    if delta.get(kern, 0) != reads:
        raise AssertionError(f"{what}: {reads} reads launched {kern} "
                             f"{delta.get(kern, 0)} times")


def phase_reco_service(torch, np, card, device="cuda"):
    """Phase 11b: the recommender.  (1) bench.py's lsh H 128 config on a
    port server: RECO_ROWS update_row calls over the wire, RECO_DROPS
    clear_rows (holes in the mask), RECO_READS similar_row_from_datum and
    8 similar_row_from_id reads, every answer bitwise an in-process
    driver's fed the same calls; each read launches K1 and the masked K3
    once (the server's counters and the driver's).  K1 at this path's H
    128 (the 8,192 rows of the first read's sync, and a read's one datum)
    and the masked K3 on the served table at a read's kb, each bitwise
    its plain version on the same card tensors and timed.  (2)
    inverted_index at 10^6 rows of 16 features (injected into the host
    rows and written to the store in one write, as bench.py:921-928
    fills the driver), 1% dropped, 32 reads and one of 1,500 rows (kb
    2048: K4's sort path), each one K4 dense_topk launch, five of them
    against the plain version; a read's time.  Returns the launches and
    the K1 and K3 rows."""
    from jubatus_tpu_torch.fv import Datum, SparseBatch
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(31)
    data = row_datums(np, rng, RECO_ROWS + RECO_READS, 4096)
    drv = create_driver("recommender", RECO_CONFIG, device=device)
    served = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "reco.json")
        with open(cfg_path, "w") as f:
            json.dump(RECO_CONFIG, f)
        child, t0 = start_server("recommender", cfg_path, tmp, device=device)
        try:
            port, _ = server_ready(child, t0)
            cli = WireClient(port)
            t0 = time.perf_counter()
            for i, d in enumerate(data[:RECO_ROWS]):
                cli.call("update_row", f"r{i}", nn_wire(d))
                drv.update_row(f"r{i}", nn_datum(Datum, d))
            upd_s = time.perf_counter() - t0
            for i in rng.choice(RECO_ROWS, RECO_DROPS, replace=False):
                if cli.call("clear_row", f"r{i}") is not True or \
                        not drv.clear_row(f"r{i}"):
                    raise AssertionError("reco: clear_row failed")
            s0 = launches_of(status_of(cli))
            before = launch_counts()
            t0 = time.perf_counter()
            for d in data[RECO_ROWS:]:
                a = cli.call("similar_row_from_datum", nn_wire(d), NN_SIZE)
                b = drv.similar_row_from_datum(nn_datum(Datum, d), NN_SIZE)
                if [tuple(x) for x in a] != [tuple(x) for x in b]:
                    raise AssertionError("reco: a read differs from the "
                                         "in-process driver's")
            read_s = time.perf_counter() - t0
            live = [i for i in (f"r{k * 97}" for k in range(40))
                    if i in drv.ids][:8]
            for i in live:
                a = cli.call("similar_row_from_id", i, NN_SIZE)
                b = drv.similar_row_from_id(i, NN_SIZE)
                if [tuple(x) for x in a] != [tuple(x) for x in b]:
                    raise AssertionError("reco: a from_id read differs")
            reads = RECO_READS + 8
            delta = launch_delta(before, launch_counts())
            sdelta = launch_delta(s0, launches_of(status_of(cli)))
            if device == "cuda":
                check_reads("reco (in process)", delta, reads, "sig_topk")
                check_reads("reco (server)", sdelta, reads, "sig_topk")
                if delta["lsh_signature"] < reads:
                    raise AssertionError("reco: a read did not sign")
            served = launches_of(status_of(cli))
            cli.call("save", "reco")
        finally:
            child.stop()
    log(f"reco: lsh H 128, {RECO_ROWS} update_rows over the wire in "
        f"{upd_s:.1f} s (both sides), {RECO_READS} datum reads in "
        f"{read_s:.2f} s; server launches {served}")
    # K1 at H 128 as this path runs it: the first read's sync signed the
    # RECO_ROWS rows as one batch (the live ones here, padded to that
    # count with repeats as the sync pads), a read signs its one datum;
    # then K3 on the served table with its mask, at a read's kb
    dev = torch.device(device)
    live = [i for i in (f"r{k}" for k in range(RECO_ROWS)) if i in drv.ids]
    _, idx_np, val_np, _ = drv._dirty_batch(live, RECO_ROWS)
    q = drv.converter.convert_row(nn_datum(Datum, data[RECO_ROWS]))
    qb = SparseBatch.from_rows([q])
    qi, qv = L._host(qb.indices, np.int32, dev), L._host(qb.values,
                                                        np.float32, dev)
    k1 = [k1_at(torch, L, drv.key, L._host(idx_np, np.int32, dev),
                L._host(val_np, np.float32, dev), 128, None, "reco sync",
                device),
          k1_at(torch, L, drv.key, qi, qv, 128, None, "reco read", device)]
    t = drv._sync()
    qn = torch.tensor([float(np.sqrt(sum(v * v for v in q.values())))],
                      dtype=torch.float32, device=dev)
    k3 = topk_row(torch, np, L, "lsh", 128, t["sig"], t["norms"], t["rows"],
                  L.signature(drv.key, qi, qv, 128, "lsh"), qn, None,
                  "reco read (masked)", device,
                  kb=L._kb(NN_SIZE, t["rows"]), mask=t["mask"])
    log("reco: K1 H 128 " + "; ".join(
        f"{x['route']} at {x['shape']}: {x['ms']} ms (plain {x['plain_ms']},"
        f" bound {x['bound_ms']:.4g} by {x['bound_class']}), bitwise"
        for x in k1) + f"; masked K3 on the served table at {k3['shape']} "
        f"kb {k3['kb']}: {k3['ms']} ms (plain {k3['plain_ms']}), bitwise")
    # (2) the exact sweep at 10^6 rows
    exact = create_driver("recommender", RECO_EXACT_CONFIG, device=device)
    n = RECO_EXACT_ROWS
    ks = rng.integers(0, 4096, (n, 16))
    vs = rng.standard_normal((n, 16))
    ids = [f"e{i}" for i in range(n)]
    t0 = time.perf_counter()
    # the host rows and the dirty marks bench.py sets, the slots of one
    # allocation, then the first sync's one write
    slots = exact.pages.alloc_seq(n).tolist()
    exact.ids = dict(zip(ids, slots))
    exact.row_ids = list(ids)
    kl, vl = ks.tolist(), vs.tolist()
    exact.rows = {id_: dict(zip(kl[j], vl[j])) for j, id_ in enumerate(ids)}
    exact._dirty = dict.fromkeys(ids, True)
    exact._sync()
    fill_s = time.perf_counter() - t0
    for i in rng.choice(n, n // 100, replace=False):
        exact.clear_row(ids[i])
    qs = row_datums(np, rng, 32, 4096)
    before = launch_counts()
    t0 = time.perf_counter()
    outs = [exact.similar_row_from_datum(nn_datum(Datum, d), NN_SIZE)
            for d in qs]
    if device == "cuda":
        torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3 / len(qs)
    # a read of more rows than K3's lists hold: kb 2048, the sort path
    big = exact.similar_row_from_datum(nn_datum(Datum, qs[0]), 1500)
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads("reco exact", delta, len(qs) + 1, "dense_topk")
    p = exact.pages
    for d, out, size in list(zip(qs, outs, [NN_SIZE] * 4)) + [
            (qs[0], big, 1500)]:
        qd, qn = exact._query_row(exact.converter.convert_row(
            nn_datum(Datum, d)))
        keys = L.dense_topk_ref(
            "cosine", p.device("indices"), p.device("values"),
            p.device("norms"), p.capacity, p.mask_dev(),
            torch.from_numpy(qd[None]).to(p.device("norms").device),
            torch.tensor([qn], dtype=torch.float32,
                         device=p.device("norms").device),
            L._kb(size, p.capacity))
        r_, s_ = L.keys_to_host(keys)
        want = [(exact.row_ids[int(a)], float(b))
                for a, b in zip(r_[0], s_[0])][:size]
        if [tuple(x) for x in out] != want:
            raise AssertionError(f"reco exact: a read of {size} differs "
                                 "from the plain version")
    log(f"reco: inverted_index at {n} rows ({p.capacity} slots, Kr "
        f"{exact.kr}): filled in {fill_s:.1f} s, a read {read_ms:.3f} ms")
    return ({**{k: served.get(k, 0) for k in ("sig_topk", "lsh_signature")},
             "dense_topk": delta.get("dense_topk", 0)},
            {"lsh_signature": k1, "sig_topk": [k3]})


def phase_anomaly_service(torch, np, card, device="cuda"):
    """Phase 11c: anomaly.  (1) bench.py's lof over euclid_lsh H 64 on a
    port server: ANOM_ADDS adds over the wire (server-minted ids 1, 2,
    ...), every score bitwise an in-process driver's fed the same ids and
    datums, then ANOM_READS calc_score reads, bitwise; each sweep one K5
    launch.  (2) lof over inverted_index_euclid in process: ANOM_EXACT_ADDS
    adds, each sweep one K4 dense_dots launch, the scores bitwise a CPU
    driver's.  Returns the launches."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    rng = np.random.default_rng(41)
    data = row_datums(np, rng, ANOM_ADDS + ANOM_READS, 1 << 16)
    drv = create_driver("anomaly", LOF_CONFIG, device=device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "lof.json")
        with open(cfg_path, "w") as f:
            json.dump(LOF_CONFIG, f)
        child, t0 = start_server("anomaly", cfg_path, tmp, device=device)
        try:
            port, _ = server_ready(child, t0)
            cli = WireClient(port)
            s0 = launches_of(status_of(cli))
            before = launch_counts()
            t0 = time.perf_counter()
            lat = []
            for i, d in enumerate(data[:ANOM_ADDS]):
                # the server mints ids 1, 2, ...; after ANOM_TIMED adds the
                # driver's add runs while the server's is in flight
                rid = str(i + 1)
                if i < ANOM_TIMED:
                    t1 = time.perf_counter()
                    got = cli.call("add", nn_wire(d))
                    lat.append(time.perf_counter() - t1)
                    mine = drv.add(rid, nn_datum(Datum, d))
                else:
                    cli.sock.sendall(cli.frame("add", nn_wire(d)))
                    mine = drv.add(rid, nn_datum(Datum, d))
                    got = cli.receive()
                if got != [rid, mine]:
                    raise AssertionError(f"anomaly: add {rid} answered {got}"
                                         f", the in-process driver {mine}")
            add_s = time.perf_counter() - t0
            for d in data[ANOM_ADDS:]:
                if cli.call("calc_score", nn_wire(d)) != \
                        drv.calc_score(nn_datum(Datum, d)):
                    raise AssertionError("anomaly: calc_score differs")
            sweeps = ANOM_ADDS + ANOM_READS
            delta = launch_delta(before, launch_counts())
            sdelta = launch_delta(s0, launches_of(status_of(cli)))
            if device == "cuda":
                check_reads("anomaly (in process)", delta, sweeps,
                            "sig_counts")
                check_reads("anomaly (server)", sdelta, sweeps, "sig_counts")
            served = launches_of(status_of(cli))
        finally:
            child.stop()
    lat_ms = sorted(x * 1e3 for x in lat)
    log(f"anomaly: lof euclid_lsh H 64, {ANOM_ADDS} adds over the wire in "
        f"{add_s:.1f} s (both sides; the first {ANOM_TIMED} wire adds p50 "
        f"{lat_ms[len(lat_ms) // 2]:.3f} ms, p99 "
        f"{lat_ms[int(len(lat_ms) * 0.99)]:.3f} ms); server launches "
        f"{served}")
    exact = [create_driver("anomaly", LOF_EXACT_CONFIG, device=dv)
             for dv in (device, "cpu")]
    before = launch_counts()
    for i, d in enumerate(data[:ANOM_EXACT_ADDS]):
        a, b = (x.add(f"x{i}", nn_datum(Datum, d)) for x in exact)
        if a != b:
            raise AssertionError(f"anomaly exact: add {i} differs from the "
                                 "CPU driver's")
    delta = launch_delta(before, launch_counts())
    if device == "cuda" and delta["dense_dots"] < ANOM_EXACT_ADDS:
        raise AssertionError("anomaly exact: an add did not sweep through "
                             "dense_dots")
    log(f"anomaly: lof inverted_index_euclid, {ANOM_EXACT_ADDS} adds, "
        f"dense_dots launches {delta['dense_dots']}")
    return ({"sig_counts": served.get("sig_counts", 0),
             "lsh_signature": served.get("lsh_signature", 0),
             "dense_dots": delta.get("dense_dots", 0)}, {})


def phase_nn_classifier(torch, np, card, device="cuda"):
    """Phase 11d: the NN classifier (euclid_lsh H 64, k 128) on bench.py's
    converter: NNC_TRAINS train requests of NNC_B datums to a port server
    and to an in-process driver, then NNC_READS classify requests of 8,
    the answers bitwise (labels vote by row order, so the rows' random
    ids do not matter); a classify is one K1 and one K3 launch (kb 128).
    Then K1 and K3 at a classify's shapes (8 datums signed as a batch of
    round_b(8), the served table's capacity, kb 128: the lists' offer and
    rank-merge branch), each bitwise its plain version on the same card
    tensors and timed.  Returns the launches and the K1 and K3 rows."""
    from jubatus_tpu_torch.batching.bucketing import round_b
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(51)
    drv = create_driver("classifier", NNC_CONFIG, device=device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "nnc.json")
        with open(cfg_path, "w") as f:
            json.dump(NNC_CONFIG, f)
        child, t0 = start_server("classifier", cfg_path, tmp, device=device)
        try:
            port, _ = server_ready(child, t0)
            cli = WireClient(port)
            t0 = time.perf_counter()
            for _ in range(NNC_TRAINS):
                batch = bench_batch(rng, NNC_B)
                cli.call("train", batch)
                drv.train([(lbl, Datum.from_msgpack(d)) for lbl, d in batch])
            train_s = time.perf_counter() - t0
            s0 = launches_of(status_of(cli))
            before = launch_counts()
            t0 = time.perf_counter()
            for _ in range(NNC_READS):
                q = [d for _, d in bench_batch(rng, 8)]
                a = cli.call("classify", q)
                b = drv.classify([Datum.from_msgpack(d) for d in q])
                if [[tuple(x) for x in row] for row in a] != \
                        [[tuple(x) for x in row] for row in b]:
                    raise AssertionError("nnc: classify differs from the "
                                         "in-process driver's")
            read_s = time.perf_counter() - t0
            delta = launch_delta(before, launch_counts())
            sdelta = launch_delta(s0, launches_of(status_of(cli)))
            if device == "cuda":
                check_reads("nnc (in process)", delta, NNC_READS, "sig_topk")
                check_reads("nnc (server)", sdelta, NNC_READS, "sig_topk")
            served = launches_of(status_of(cli))
        finally:
            child.stop()
    log(f"nnc: NN euclid_lsh H 64 k 128, {NNC_TRAINS} x {NNC_B} trains in "
        f"{train_s:.1f} s, {NNC_READS} classify x 8 in {read_s:.2f} s; "
        f"server launches {served}")
    nn = drv.nn
    dev = nn.sig.device
    batch = nn.converter.convert_batch(
        [Datum.from_msgpack(d) for _, d in bench_batch(rng, 8)])
    qi = L._host(batch.indices, np.int32, dev)
    qv = L._host(batch.values, np.float32, dev)
    qn = L._host(np.sqrt((batch.values * batch.values).sum(axis=1)),
                 np.float32, dev)
    k1 = k1_at(torch, L, nn.key, qi, qv, nn.hash_num, round_b(8),
               "nnc classify", device)
    k3 = topk_row(torch, np, L, nn.method, nn.hash_num, nn.sig, nn.norms,
                  nn.pages.n_rows,
                  L.signature(nn.key, qi, qv, nn.hash_num, nn.method,
                              round_b(8)),
                  qn, None, "nnc classify", device,
                  kb=L._kb(drv.k, nn.sig.shape[0]))
    log(f"nnc: K1 at {k1['shape']}: {k1['ms']} ms (plain {k1['plain_ms']}), "
        f"bitwise; K3 on the served table at {k3['shape']} kb {k3['kb']} "
        f"({k3['valid_rows']} valid): {k3['ms']} ms (plain "
        f"{k3['plain_ms']}, topk {k3['library_ms']}, bound "
        f"{k3['bound_ms']:.4g} by {k3['bound_class']}), bitwise")
    return ({k: served.get(k, 0) for k in ("sig_topk", "lsh_signature")},
            {"lsh_signature": [k1], "sig_topk": [k3]})


# ---------------------------------------------------------------------------
# phase 12: the sublinear query index (K6 sig_probe, K7 ivf_probe)
# ---------------------------------------------------------------------------

INDEX_ROWS = 10 ** 6       # bench.py:1199's 10^6-row tables
# the ivf table cut to a quarter, as phase 10's: at 10^6 rows its fill and
# host build alone pass the phase's share of the time limit
# (scripts/torch_probe_split.py --ivf-rows 1000000 times that build)
INDEX_IVF_ROWS = 250_000
INDEX_WINDOW = 32          # wire writes in flight at once
INDEX_PROTOS = 4096        # bench.py:1243's prototypes
INDEX_READS = 64           # reads of each route
INDEX_PROBES = 4           # bench.py's probes
INDEX_WIRE_ROWS = 9216     # writes to each server: above min_rows 8,192
                           # (16,384 before phase 15 came, 10,240 before
                           # phase 16)
INDEX_ANOM_ADDS = 2048     # ROADMAP's floor
INDEX_ANOM_CONFIG = dict(LOF_CONFIG, index={"min_rows": 0})
IVF_CONFIG = {             # bench.py:1226: inverted_index on 4096 columns
    "method": "inverted_index", "parameter": {},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 4096},
}
# phase 12c's third server: ivf at a count-sketch width past 1,024 (the
# squares' windows windowed again), engaged from its first write
IVF_WIDE_CONFIG = dict(IVF_CONFIG, index={"min_rows": 0, "embed_dim": 2048})
INDEX_WIDE_ROWS = 4096


def probe_bound(kind, w, slots, n_cand, nq, kb):
    """K6's least time in ms by class for this run's data: the bytes it
    must move (the probed groups' and the delta's candidate ids, each
    valid candidate's signature (and norm for euclid_lsh), the queries,
    the results) and the valid candidates' popcounts, integer operations
    and euclid estimate, each class at its own rate.  The selection's
    compares are not counted (as K3's)."""
    norms = 4 if kind == "euclid_lsh" else 0
    nbytes = (slots * 4 + n_cand * (w * 4 + norms) + nq * (w * 4 + 4)
              + nq * (2 * kb + 1) * 8)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "int32": n_cand * 2 * w / INT32_OPS_PER_S * 1e3,
            "popc": (0 if kind == "minhash" else n_cand * w) / POPC_PER_S
            * 1e3,
            "f32": (n_cand * 8 if kind == "euclid_lsh" else 0)
            / F32_OPS_PER_S * 1e3,
            "sfu": (n_cand if kind == "euclid_lsh" else 0) / SFU_PER_S * 1e3}


def ivf_bound(c, e, k, d, kr, slots, n_cand, kb):
    """K7's least time in ms by class: the bytes (the centroids, the
    query's sparse and dense forms, the candidate ids, each valid
    candidate's Kr indices, values and norm, the result) and the float32
    operations (the C centroid dots and squares, 4 E each; a candidate's
    Kr multiply-adds and its tail) and the tails' division or sqrt."""
    nbytes = (c * e * 4 + k * 8 + d * 4 + slots * 4 + n_cand * (kr * 8 + 4)
              + (2 * kb + 1) * 8)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "f32": (c * e * 4 + n_cand * (kr * 2 + 4)) / F32_OPS_PER_S * 1e3,
            "sfu": n_cand / SFU_PER_S * 1e3}


def cand_slots(csr, groups):
    """Candidate ids the probe reads: the probed groups' lengths (at most
    cap) plus the delta's width."""
    flat, offsets, lens, delta, cap = csr
    return int(lens[groups].clamp_max(cap).sum()) + int(delta.shape[0])


def index_answers(drv, reads, full):
    """Each read's answer with the index, then with the full sweep (the
    index set aside): (pruned, full) lists."""
    pruned = [read() for read in reads]
    saved, drv.index = drv.index, None
    try:
        whole = [read() for read in full]
    finally:
        drv.index = saved
    return pruned, whole


def recall_of(pruned, whole):
    from jubatus_tpu_torch.index import tie_aware_recall
    return sum(tie_aware_recall(f, p, NN_SIZE)
               for p, f in zip(pruned, whole)) / len(pruned)


def phase_index_nn(torch, np, device="cuda"):
    """Phase 12a: nearest_neighbor lsh H 64 (bench.py:1240-1258) at
    INDEX_ROWS rows: INDEX_PROTOS prototype datums signed by K1, every row
    one prototype's signature with one bit flipped, written to the store
    in one write (bench.py injects the table: a 10^6-row set_row build
    would measure the converter), --index lsh_probe at INDEX_PROBES
    probes built through its real lazy rebuild (host seconds printed).
    INDEX_READS similar_row_from_id and INDEX_READS similar_row_from_datum
    reads (prototype datums, jittered): one K6 launch a read, plus K1 for
    a datum; each read's K6 result (keys, rows, n_cand) bitwise the plain
    version's on the same card tensors and its answer the plain version's
    decoded; the tie-aware recall at k 10 against the full sweep (K3), the
    candidates a query; K6's device ms beside K3's full sweep of the same
    table.  Returns (launches, K6's row)."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(61)
    drv = create_driver("nearest_neighbor", NN_CONFIG, device=device)
    if not drv.configure_index("lsh_probe", probes=INDEX_PROBES):
        raise AssertionError("index nn: lsh_probe declined")
    protos = nn_datums(np, rng, INDEX_PROTOS)
    batch = drv.converter.convert_batch([nn_datum(Datum, d) for d in protos],
                                        update_weights=False)
    psig, _ = drv._signature(batch)
    n = INDEX_ROWS
    t0 = time.perf_counter()
    sigs = psig[rng.integers(0, INDEX_PROTOS, n)]
    sigs[np.arange(n), rng.integers(0, 2, n)] ^= \
        np.uint32(1) << rng.integers(0, 32, n, dtype=np.uint32)
    slots = drv._rows([f"r{i}" for i in range(n)])
    drv.pages.write(slots, {"sig": sigs, "norms": np.ones(n, np.float32)})
    fill_s = time.perf_counter() - t0
    drv.protos = protos        # phase 18's datum reads jitter them too
    t0 = time.perf_counter()
    idx = drv._index_for_query()           # the lazy rebuild
    csr = idx.device_csr()                 # its pack and upload
    build_s = time.perf_counter() - t0
    if idx is None or idx.needs_rebuild:
        raise AssertionError("index nn: the index did not build")
    q_ids = [f"r{i}" for i in rng.integers(0, n, INDEX_READS)]
    q_dat = []
    for p in rng.integers(0, INDEX_PROTOS, INDEX_READS):
        names, vals = protos[p]
        q_dat.append((names, (np.asarray(vals) + 0.05 * rng.standard_normal(
            NN_NNZ)).tolist()))
    reads = ([lambda i=i: drv.similar_row_from_id(i, NN_SIZE) for i in q_ids]
             + [lambda d=d: drv.similar_row_from_datum(nn_datum(Datum, d),
                                                       NN_SIZE)
                for d in q_dat])
    fb0 = float(metrics_snapshot().get("index_fallback_total", "0"))
    before = launch_counts()
    t0 = time.perf_counter()
    pruned = [read() for read in reads]
    if device == "cuda":
        torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3 / len(reads)
    delta = launch_delta(before, launch_counts())
    fallbacks = float(metrics_snapshot().get("index_fallback_total", "0")) \
        - fb0
    if device == "cuda":
        check_reads("index nn", delta, 2 * INDEX_READS, "sig_probe")
        check_reads("index nn (K1 of the datum reads)", delta, INDEX_READS,
                    "lsh_signature")
        check_reads("index nn (fallbacks)", delta, int(fallbacks),
                    "sig_topk")
    _, whole = index_answers(drv, [], reads)
    recall = recall_of(pruned, whole)
    # each read's K6 result against the plain version on the same card
    # tensors: the by-row reads in one launch of 64 queries, the datum
    # reads' signatures signed as the reads sign them (B 1)
    table, norms = drv.sig, drv.norms
    dev = table.device
    kb = C._kb(NN_SIZE, idx.plan, csr[4], csr[3])
    nv = drv.pages.n_rows
    q_rows = torch.tensor([drv.ids[i] for i in q_ids], device=dev)
    qsig = []
    for d in q_dat:
        b = drv.converter.convert_batch([nn_datum(Datum, d)],
                                        update_weights=False)
        qsig.append(L.signature(drv.key, L._host(b.indices, np.int32, dev),
                                L._host(b.values, np.float32, dev), 64,
                                "lsh"))
    qsig = torch.cat(qsig)
    qn = torch.ones(len(q_dat), dtype=torch.float32, device=dev)
    args = ("lsh", table, norms, nv, None, csr, idx.plan, idx.bits, 64, kb)
    outs = [C.sig_probe(*args, q_rows=q_rows),
            C.sig_probe(*args, q_sigs=qsig, qnorms=qn)]
    refs = [C.sig_probe_ref("lsh", table, norms, nv, None, table[q_rows],
                            norms[q_rows], *csr[:4], csr[4], idx.plan,
                            idx.bits, 64, kb),
            C.sig_probe_ref("lsh", table, norms, nv, None, qsig, qn,
                            *csr[:4], csr[4], idx.plan, idx.bits, 64, kb)]
    n_cand = []
    for out, ref, answers in zip(outs, refs, (pruned[:INDEX_READS],
                                              pruned[INDEX_READS:])):
        if not torch.equal(out, ref):
            raise AssertionError("index nn: K6 differs from its plain "
                                 "version")
        rows, scores, nc = C.probe_result(ref, kb)
        n_cand += nc.tolist()
        for i, ans in enumerate(answers):
            r, s = C.dedupe_topk(rows[i], scores[i], NN_SIZE)
            if drv._to_results(r, s, NN_SIZE, True) != ans:
                raise AssertionError("index nn: a read's answer is not its "
                                     "K6 result's")
    # K6 at one by-row read beside K3's full sweep over the same table
    one = q_rows[:1].contiguous()
    groups = C.probe_groups_ref("lsh", table[one], idx.plan, idx.bits)
    slots = cand_slots(csr, groups[0])
    width = C._cand_width(idx.plan, csr[4], csr[3])
    scores = torch.from_numpy(rng.random((1, width), dtype=np.float32)
                              ).to(dev)
    row = kernel_row(
        torch, lambda: C.sig_probe(*args, q_rows=one),
        lambda: C.sig_probe_ref("lsh", table, norms, nv, None, table[one],
                                norms[one], *csr[:4], csr[4], idx.plan,
                                idx.bits, 64, kb),
        device, 3, lib=lambda: torch.topk(scores, kb),
        classes=probe_bound("lsh", table.shape[1], slots, n_cand[0], 1, kb),
        shape=[n, table.shape[1], 1, width, kb], err=0.0)
    sweep_ms = nn_times(torch, lambda: L.sig_topk(
        "lsh", table, norms, nv, q_rows=one, hash_num=64, kb=NN_KB),
        device, 20)[0]
    dat_ms = nn_times(torch, lambda: C.sig_probe(
        *args, q_sigs=qsig[:1], qnorms=qn[:1]), device, 20)[0]
    row.update(kind="lsh", hash_num=64, probes=INDEX_PROBES,
               cap=int(csr[4]), candidates_mean=float(np.mean(n_cand)),
               datum_ms=dat_ms, full_sweep_ms=sweep_ms, recall=recall,
               build_s=build_s, read_ms=read_ms, fallbacks=fallbacks,
               route="by row")
    log(f"index nn: lsh H 64 at {n} rows (filled in {fill_s:.1f} s), "
        f"lsh_probe P {INDEX_PROBES} built in {build_s:.2f} s (host), cap "
        f"{csr[4]}, width {width}, kb {kb}; {2 * INDEX_READS} reads, "
        f"{read_ms:.3f} ms a read, {fallbacks:.0f} fallbacks, candidates a "
        f"query {np.mean(n_cand):.0f}, recall@10 {recall:.4f}; K6 "
        f"{row['ms']} ms by row, {dat_ms} ms by signature (plain "
        f"{row['plain_ms']}, topk {row['library_ms']}, bound "
        f"{row['bound_ms']:.4g}), K3's full sweep {sweep_ms} ms; bitwise")
    return {"sig_probe": delta.get("sig_probe", 0),
            "lsh_signature": delta.get("lsh_signature", 0),
            "sig_topk": delta.get("sig_topk", 0)}, row, drv


def ivf_rows(np, rng, drv, n, protos):
    """bench.py:1293-1313's table through the port's converter: each row
    one prototype datum's features (16 of 4096 columns) with its values
    jittered by 0.05; (host rows {id: {col: value}}, prototype rows)."""
    from jubatus_tpu_torch.fv import Datum
    prows = [drv.converter.convert_row(nn_datum(Datum, d)) for d in protos]
    if any(len(r) != NN_NNZ for r in prows):
        raise AssertionError("index ivf: two features of a prototype share "
                             "a column")
    pidx = [list(r.keys()) for r in prows]
    pval = np.array([list(r.values()) for r in prows])
    asn = rng.integers(0, len(protos), n)
    vals = (pval[asn] + 0.05 * rng.standard_normal(
        (n, pval.shape[1]))).astype(np.float32).tolist()
    return {f"e{j}": dict(zip(pidx[a], v))
            for j, (a, v) in enumerate(zip(asn.tolist(), vals))}


def phase_index_ivf(torch, np, device="cuda"):
    """Phase 12b: the recommender's inverted_index (bench.py:1287-1313:
    4096 columns, Kr 32, prototypes of 16 features) at INDEX_IVF_ROWS
    rows, filled as phase 11 fills its exact table (host rows, one store
    write), --index ivf at INDEX_PROBES probes built through its lazy
    rebuild (train and assign; host seconds printed); INDEX_READS
    similar_row_from_id and INDEX_READS similar_row_from_datum reads: one
    K7 launch a read, each bitwise the plain version and its answer the
    plain version's decoded; the recall at k 10 against the full sweep
    (K4); K7's device ms beside K4's full sweep.  Returns (launches, K7's
    row)."""
    from jubatus_tpu_torch.fv import Datum, SparseBatch
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(71)
    drv = create_driver("recommender", IVF_CONFIG, device=device)
    if not drv.configure_index("ivf", probes=INDEX_PROBES):
        raise AssertionError("index ivf: ivf declined")
    # prototypes whose 16 features land in 16 distinct columns
    protos = [d for d in nn_datums(np, rng, 2 * INDEX_PROTOS)
              if len(drv.converter.convert_row(nn_datum(Datum, d)))
              == NN_NNZ][:INDEX_PROTOS]
    n = INDEX_IVF_ROWS
    t0 = time.perf_counter()
    rows = ivf_rows(np, rng, drv, n, protos)
    ids = list(rows)
    slots = drv.pages.alloc_seq(n).tolist()
    drv.ids = dict(zip(ids, slots))
    drv.row_ids = list(ids)
    drv.rows = rows
    drv._dirty = dict.fromkeys(ids, True)
    drv._sync()
    fill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = drv._index_for_query()           # train, assign, pack
    csr = idx.device_csr()
    cent = idx.device_centroids()
    build_s = time.perf_counter() - t0
    if idx is None or idx.needs_rebuild:
        raise AssertionError("index ivf: the index did not build")
    q_ids = [f"e{i}" for i in rng.integers(0, n, INDEX_READS)]
    q_dat = []
    for p in rng.integers(0, INDEX_PROTOS, INDEX_READS):
        names, vals = protos[p]
        q_dat.append((names, (np.asarray(vals) + 0.05 * rng.standard_normal(
            NN_NNZ)).tolist()))
    reads = ([lambda i=i: drv.similar_row_from_id(i, NN_SIZE) for i in q_ids]
             + [lambda d=d: drv.similar_row_from_datum(nn_datum(Datum, d),
                                                       NN_SIZE)
                for d in q_dat])
    fb0 = float(metrics_snapshot().get("index_fallback_total", "0"))
    before = launch_counts()
    t0 = time.perf_counter()
    pruned = [read() for read in reads]
    if device == "cuda":
        torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3 / len(reads)
    delta = launch_delta(before, launch_counts())
    fallbacks = float(metrics_snapshot().get("index_fallback_total", "0")) \
        - fb0
    if device == "cuda":
        check_reads("index ivf", delta, 2 * INDEX_READS, "ivf_probe")
        check_reads("index ivf (fallbacks)", delta, int(fallbacks),
                    "dense_topk")
    _, whole = index_answers(drv, [], reads)
    recall = recall_of(pruned, whole)
    t = drv._sync()
    dev = t["norms"].device
    probes = min(INDEX_PROBES, cent.shape[0])
    kb = C._ivf_kb(NN_SIZE, probes, csr[4], csr[3])
    n_cand = []
    first = None
    for q, ans in zip([drv.rows[i] for i in q_ids]
                      + [drv.converter.convert_row(nn_datum(Datum, d))
                         for d in q_dat], pruned):
        b = SparseBatch.from_rows([q])
        qd, _ = drv._query_row(q)
        qn = float(np.sqrt(sum(v * v for v in q.values())))
        qargs = (L._host(b.indices[0], np.int32, dev),
                 L._host(b.values[0], np.float32, dev),
                 L._host(qd, np.float32, dev))
        out = C.ivf_probe("cosine", *qargs, qn, cent, t["indices"],
                          t["values"], t["norms"], t["rows"], t["mask"], csr,
                          probes, idx.embed_dim, kb)
        ref = C.ivf_probe_ref("cosine", *qargs, torch.tensor(
            np.float32(qn), device=dev), cent, t["indices"], t["values"],
            t["norms"], t["rows"], t["mask"], *csr[:4], csr[4], probes,
            idx.embed_dim, kb)
        if not torch.equal(out, ref):
            raise AssertionError("index ivf: K7 differs from its plain "
                                 "version")
        r, s, nc = C.probe_result(ref, kb)
        n_cand.append(int(nc[0]))
        r, s = C.dedupe_topk(r[0], s[0], NN_SIZE)
        if drv._trim_results(r, s, NN_SIZE) != ans:
            raise AssertionError("index ivf: a read's answer is not its K7 "
                                 "result's")
        if first is None:
            first = (qargs, qn, q)
    qargs, qn, q = first
    e_q = C.cs_embed_ref(qargs[0], qargs[1], idx.embed_dim)
    top = torch.topk(L.scores_to_keys(C.centroid_scores_ref(cent, e_q)),
                     probes).values
    top_c = L.MASK32 - (top & L.MASK32)
    slots = cand_slots(csr, torch.cat([top_c, top_c + cent.shape[0]]))
    width = 2 * probes * csr[4] + csr[3].shape[0]
    scores = torch.from_numpy(rng.random((1, width), dtype=np.float32)
                              ).to(dev)

    def k7():
        return C.ivf_probe("cosine", *qargs, qn, cent, t["indices"],
                           t["values"], t["norms"], t["rows"], t["mask"],
                           csr, probes, idx.embed_dim, kb)

    row = kernel_row(
        torch, k7, lambda: C.ivf_probe_ref(
            "cosine", *qargs, torch.tensor(np.float32(qn), device=dev),
            cent, t["indices"], t["values"], t["norms"], t["rows"],
            t["mask"], *csr[:4], csr[4], probes, idx.embed_dim, kb),
        device, 2, lib=lambda: torch.topk(scores, kb),
        classes=ivf_bound(cent.shape[0], idx.embed_dim, qargs[0].shape[0],
                          qargs[2].shape[0], t["indices"].shape[1], slots,
                          n_cand[0], kb),
        shape=[n, t["indices"].shape[1], int(cent.shape[0]), width, kb],
        err=0.0)
    qd_t = qargs[2][None]
    qn_t = torch.tensor([qn], dtype=torch.float32, device=dev)
    sweep_ms = nn_times(torch, lambda: L.dense_topk(
        "cosine", t["indices"], t["values"], t["norms"], t["rows"],
        t["mask"], qd_t, qn_t, L._kb(NN_SIZE, t["rows"])), device, 20)[0]
    row.update(metric="cosine", probes=probes, cap=int(csr[4]),
               centroids=int(cent.shape[0]), rows=n,
               candidates_mean=float(np.mean(n_cand)), full_sweep_ms=sweep_ms,
               recall=recall, build_s=build_s, read_ms=read_ms,
               fallbacks=fallbacks, route="by row")
    log(f"index ivf: inverted_index at {n} rows (filled in {fill_s:.1f} s), "
        f"ivf C {cent.shape[0]} P {probes} built in {build_s:.2f} s (host), "
        f"cap {csr[4]}, width {width}, kb {kb}; {2 * INDEX_READS} reads, "
        f"{read_ms:.3f} ms a read, {fallbacks:.0f} fallbacks, candidates a "
        f"query {np.mean(n_cand):.0f}, recall@10 {recall:.4f}; K7 "
        f"{row['ms']} ms (plain {row['plain_ms']}, topk "
        f"{row['library_ms']}, bound {row['bound_ms']:.4g}), K4's full "
        f"sweep {sweep_ms} ms; bitwise")
    return {"ivf_probe": delta.get("ivf_probe", 0),
            "dense_topk": delta.get("dense_topk", 0)}, row, drv


def metrics_snapshot():
    from jubatus_tpu_torch.utils.metrics import GLOBAL
    return GLOBAL.snapshot()


def phase_index_wire(torch, np, device="cuda"):
    """Phase 12c: over the wire, a nearest_neighbor server (lsh H 64)
    with --index lsh_probe --index_probes 4 and a recommender
    inverted_index server with --index ivf, INDEX_WIRE_ROWS writes each
    (above the default min_rows), and an inverted_index server with
    --index ivf at embed_dim 2048 (IVF_WIDE_CONFIG), INDEX_WIDE_ROWS
    writes; then INDEX_READS reads each (datum and by id), every answer
    equal to an in-process port driver's with the same index fed the same
    writes, as phase 11 checks; each read one K6 (K7) call on both sides;
    the get_status index keys.  Returns the server processes'
    launches."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    rng = np.random.default_rng(81)
    served = {}
    for service, cfg, kind, write, kern, n_writes in (
            ("nearest_neighbor", NN_CONFIG, "lsh_probe", "set_row",
             "sig_probe", INDEX_WIRE_ROWS),
            ("recommender", IVF_CONFIG, "ivf", "update_row", "ivf_probe",
             INDEX_WIRE_ROWS),
            ("recommender", IVF_WIDE_CONFIG, "ivf", "update_row",
             "ivf_probe", INDEX_WIDE_ROWS)):
        drv = create_driver(service, cfg, device=device)
        if not drv.configure_index(kind, probes=INDEX_PROBES):
            raise AssertionError(f"index wire: {kind} declined")
        protos = nn_datums(np, rng, 256)
        data = []
        for p in rng.integers(0, len(protos), n_writes + INDEX_READS):
            names, vals = protos[p]
            data.append((names, (np.asarray(vals) + 0.05
                                 * rng.standard_normal(NN_NNZ)).tolist()))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            cfg_path = os.path.join(tmp, "index.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            child, t0 = start_server(service, cfg_path, tmp, "--index",
                                     kind, "--index_probes",
                                     str(INDEX_PROBES), device=device)
            try:
                port, _ = server_ready(child, t0)
                cli = WireClient(port)
                t0 = time.perf_counter()
                # INDEX_WINDOW writes in flight while the in-process
                # driver takes the same ones; the server answers in order
                for w0 in range(0, n_writes, INDEX_WINDOW):
                    win = range(w0, min(w0 + INDEX_WINDOW, n_writes))
                    cli.sock.sendall(b"".join(
                        cli.frame(write, f"w{i}", nn_wire(data[i]))
                        for i in win))
                    for i in win:
                        getattr(drv, write)(f"w{i}", nn_datum(Datum, data[i]))
                    for _ in win:
                        if cli.receive() is not True:
                            raise AssertionError(f"index wire: {write} "
                                                 "failed")
                write_s = time.perf_counter() - t0
                s0 = launches_of(status_of(cli))
                before = launch_counts()
                t0 = time.perf_counter()
                for j, d in enumerate(data[n_writes:]):
                    if j % 2:
                        rid = f"w{int(rng.integers(0, n_writes))}"
                        a = cli.call("similar_row_from_id", rid, NN_SIZE)
                        b = drv.similar_row_from_id(rid, NN_SIZE)
                    else:
                        a = cli.call("similar_row_from_datum", nn_wire(d),
                                     NN_SIZE)
                        b = drv.similar_row_from_datum(nn_datum(Datum, d),
                                                       NN_SIZE)
                    if [tuple(x) for x in a] != [tuple(x) for x in b]:
                        raise AssertionError(f"index wire: a {service} read "
                                             "differs from the in-process "
                                             "driver's")
                read_s = time.perf_counter() - t0
                delta = launch_delta(before, launch_counts())
                st = status_of(cli)
                sdelta = launch_delta(s0, launches_of(st))
                if device == "cuda":
                    check_reads(f"index wire {service} (in process)", delta,
                                INDEX_READS, kern)
                    check_reads(f"index wire {service} (server)", sdelta,
                                INDEX_READS, kern)
                want = {"index": kind, "index_probes": str(INDEX_PROBES),
                        "index_live_rows": str(n_writes),
                        "index_needs_rebuild": "0"}
                if any(st.get(k) != v for k, v in want.items()) or \
                        float(st.get("index_probe_total", 0)) < INDEX_READS \
                        or float(st.get("index_rebuild_total", 0)) < 1:
                    raise AssertionError(f"index wire: {service} get_status "
                                         f"index keys {st}")
                for k, v in launches_of(st).items():
                    served[k] = served.get(k, 0) + v
            finally:
                child.stop()
        log(f"index wire: {service} --index {kind}: {n_writes} "
            f"{write}s in {write_s:.1f} s (both sides), {INDEX_READS} reads "
            f"in {read_s:.2f} s, bitwise the in-process driver; status "
            + ", ".join(f"{k}={st[k]}" for k in sorted(st)
                        if k.startswith("index")))
    return served


def phase_index_anomaly(torch, np, device="cuda"):
    """Phase 12d: anomaly lof over euclid_lsh H 64 (bench.py:824-831) with
    the config's "index": {"min_rows": 0} in process: INDEX_ANOM_ADDS adds
    (the write path's exact sweeps, K5), then INDEX_READS calc_score reads
    with the index engaged, one K6 launch each (K5 where a read falls
    back); each read's K6 result bitwise the plain version; the share of
    scores equal to the full sweep's.  Returns the launches."""
    from jubatus_tpu_torch.fv import Datum, SparseBatch
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(91)
    drv = create_driver("anomaly", INDEX_ANOM_CONFIG, device=device)
    if not drv.configure_index("lsh_probe", probes=INDEX_PROBES) or \
            drv.index.spec.min_rows != 0:
        raise AssertionError("index anomaly: the index did not configure")
    protos = nn_datums(np, rng, 64)
    data = []
    for p in rng.integers(0, len(protos), INDEX_ANOM_ADDS + INDEX_READS):
        names, vals = protos[p]
        data.append((names, (np.asarray(vals) + 0.05
                             * rng.standard_normal(NN_NNZ)).tolist()))
    t0 = time.perf_counter()
    for i, d in enumerate(data[:INDEX_ANOM_ADDS]):
        drv.add(f"a{i}", nn_datum(Datum, d))
    add_s = time.perf_counter() - t0
    qs = [nn_datum(Datum, d) for d in data[INDEX_ANOM_ADDS:]]
    fb0 = float(metrics_snapshot().get("index_fallback_total", "0"))
    before = launch_counts()
    scores = [drv.calc_score(q) for q in qs]
    delta = launch_delta(before, launch_counts())
    fallbacks = float(metrics_snapshot().get("index_fallback_total", "0")) \
        - fb0
    if device == "cuda":
        check_reads("index anomaly", delta, INDEX_READS, "sig_probe")
        check_reads("index anomaly (fallbacks)", delta, int(fallbacks),
                    "sig_counts")
    if any(np.isnan(s) for s in scores):
        raise AssertionError("index anomaly: a score is NaN")
    saved, drv.index = drv.index, None
    full = [drv.calc_score(q) for q in qs]
    drv.index = saved
    same = sum(a == b for a, b in zip(scores, full)) / len(qs)
    idx = drv.index
    csr = idx.device_csr()
    p = drv.pages
    dev = p.device("sig").device
    kb = C._kb(drv.nn_num, idx.plan, csr[4], csr[3])
    rows = [drv.converter.convert_row(q) for q in qs]
    qsig = []
    for r in rows:              # signed one at a time, as calc_score signs
        b = SparseBatch.from_rows([r])
        qsig.append(L.signature(drv.key, L._host(b.indices, np.int32, dev),
                                L._host(b.values, np.float32, dev), 64,
                                "euclid_lsh"))
    qsig = torch.cat(qsig)
    qn = torch.tensor([float(np.sqrt(sum(v * v for v in r.values())))
                       for r in rows], dtype=torch.float32, device=dev)
    args = ("euclid_lsh", p.device("sig"), p.device("norms"), p.capacity,
            p.mask_dev(), csr, idx.plan, idx.bits, 64, kb)
    out = C.sig_probe(*args, q_sigs=qsig, qnorms=qn)
    ref = C.sig_probe_ref("euclid_lsh", p.device("sig"), p.device("norms"),
                          p.capacity, p.mask_dev(), qsig, qn, *csr[:4],
                          csr[4], idx.plan, idx.bits, 64, kb)
    if not torch.equal(out, ref):
        raise AssertionError("index anomaly: K6 differs from its plain "
                             "version")
    log(f"index anomaly: lof euclid_lsh H 64, {INDEX_ANOM_ADDS} adds in "
        f"{add_s:.1f} s, {INDEX_READS} calc_score reads through K6 "
        f"({fallbacks:.0f} fallbacks), {same:.3f} of the scores equal to "
        f"the full sweep's; K6 bitwise at {len(qs)} queries")
    return {"sig_probe": delta.get("sig_probe", 0)}


# ---------------------------------------------------------------------------
# phase 13: the spill tier (pages.resident_pages > 0)
# ---------------------------------------------------------------------------

SPILL_PAGE_ROWS = 128
# (cell, rows, resident pages): bench.py:1067-1077's spill cell (4x its
# budget), then bench_paged_rows' 10^6 rows at a quarter resident
SPILL_NN_CELLS = (("a", 65_536, 128), ("b", 10 ** 6, 1953))
SPILL_RECO_ROWS = 250_000
SPILL_RECO_BUDGET = 488
SPILL_READS = 64           # reads of each route, checked and timed
SPILL_SPLITS = 8           # reads split by stage
SPILL_ANOM_ADDS = 1024     # 2,048 before phase 15 came; ROADMAP's floor
SPILL_ANOM_READS = 64
SPILL_WIRE_ROWS = 8_192    # 16,384 before phase 15 came; ROADMAP's floor
SPILL_WIRE_BUDGET = 16     # a quarter of the wire table's 64 pages
SPILL_WIRE_READS = 64


class _CheckedWrapper:
    """Stands in for a kernel's wrapper: calls it, then holds a card
    launch's output against the plain version.  It keeps no count of its
    own: `launches` reads and writes the wrapper's, so each launch is
    counted once on the wrapper whichever name the wrapper counts by."""

    def __init__(self, check, orig):
        self._check, self._orig = check, orig
        self.__name__ = orig.__name__

    def __call__(self, *args, **kw):
        out = self._orig(*args, **kw)
        self._check(out, args)
        return out

    @property
    def launches(self):
        return self._orig.launches

    @launches.setter
    def launches(self, n):
        self._orig.launches = n


class Checked:
    """Within the block every call of the wrapper L.<name> (the kernel's
    launch on the card, counted by the wrapper) is held against its plain
    version on the same card tensors, bitwise, right after the launch and
    before the sweep reuses the buffer; the checks launch nothing."""

    def __init__(self, torch, L, name, ref, nargs):
        self.torch, self.L, self.name, self.ref = torch, L, name, ref
        self.nargs = nargs
        self.calls = 0

    def _check(self, out, args):
        if out.device.type != "cuda":
            return
        want = self.ref(*args[: self.nargs])
        if not self.torch.equal(out.view(self.torch.int32),
                                want.view(self.torch.int32)):
            raise AssertionError(f"spill: a {self.name} launch differs "
                                 "from its plain version")
        self.calls += 1

    def __enter__(self):
        self.orig = getattr(self.L, self.name)
        setattr(self.L, self.name, _CheckedWrapper(self._check, self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.L, self.name, self.orig)


def tie_eq(a, b, tol=0.0):
    """Tie-aware equality (tests/test_paged.py's): the scores equal
    position by position (within tol, absolute, where given: the exact
    methods' spilled score is the host's arithmetic on K4 dense_dots'
    sums, not the fused sweep's einsum order), and every row scoring
    above the k-th score by more than twice tol in one answer named in
    the other (a tie at the boundary may name other rows)."""
    sa = [float(s) for _, s in a]
    sb = [float(s) for _, s in b]
    if len(sa) != len(sb) or any(abs(x - y) > tol
                                 for x, y in zip(sa, sb)):
        return False
    if not sa:
        return True
    ia, ib = {i for i, _ in a}, {i for i, _ in b}
    return ({i for i, s in a if s > sa[-1] + 2 * tol} <= ib
            and {i for i, s in b if s > sb[-1] + 2 * tol} <= ia)


def pinned_rate(torch, nbytes, reps=10):
    """GB/s of a plain pinned host-to-card copy_ of nbytes (CUDA events):
    the link's yardstick."""
    h = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    d.copy_(h, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        d.copy_(h, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del h, d
    return ms, nbytes / ms / 1e6


def spill_counters():
    snap = metrics_snapshot()
    return tuple(float(snap.get(k, 0)) for k in ("page_spill_in_total",
                                                "page_spill_out_total"))


def spill_split(torch, np, P, store, sweep_one, reads, device):
    """The split of `reads` spilled reads' score sweeps (ms each, the
    mean): the pool sweep, the chunks' copies, the chunks' sweeps, the
    scores' copy back (device events), the host top-k (host clock), the
    bytes streamed and the link rate the copies reach."""
    keys = ("pool_ms", "copy_ms", "chunk_ms", "back_ms")
    acc = {k: 0.0 for k in keys + ("topk_ms",)}
    t = {}
    for q in reads:
        t = {}
        scores = sweep_one(q, t)
        t0 = time.perf_counter()
        P.topk(scores, store.mask_host(), NN_SIZE)
        acc["topk_ms"] += (time.perf_counter() - t0) * 1e3
        for k in keys:
            acc[k] += t[k]
    out = {k: v / len(reads) for k, v in acc.items()}
    out["streamed_bytes"] = t["streamed_bytes"]
    out["streamed_pages"] = t["streamed_pages"]
    out["copy_gb_s"] = t["streamed_bytes"] / max(out["copy_ms"], 1e-9) / 1e6
    if device == "cuda":
        ms, rate = pinned_rate(torch, t["streamed_bytes"])
        out.update(pinned_copy_ms=ms, pinned_gb_s=rate)
    return out


def timed_reads(np, reads):
    lat = []
    for read in reads:
        t0 = time.perf_counter()
        read()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def spill_nn_cell(torch, np, name, rows, budget, device="cuda"):
    """Phase 13a/b: nearest_neighbor lsh H 64 (NN_CONFIG) at `rows` rows
    of random signatures (bench.py:1068's table), written through the
    spilled store in one write (it faults the pages in windows of the
    budget) and into a resident twin; SPILL_READS similar_row_from_id and
    SPILL_READS similar_row_from_datum reads on each, every spilled answer
    tie-aware the twin's and every K5 scores launch bitwise its plain
    version, one launch for the pool and one a chunk; then the same reads
    timed (host clock) and a read's split."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.ops import paged as P
    cfg = dict(NN_CONFIG, pages={"page_rows": SPILL_PAGE_ROWS,
                                 "resident_pages": budget})
    spill = create_driver("nearest_neighbor", cfg, device=device)
    twin = create_driver("nearest_neighbor", NN_CONFIG, device=device)
    rng = np.random.default_rng(rows)
    sigs = rng.integers(0, 2 ** 32, (rows, 2), dtype=np.uint64) \
        .astype(np.uint32)
    norms = np.ones(rows, np.float32)
    ids = [f"s{i}" for i in range(rows)]
    c0 = spill_counters()
    t0 = time.perf_counter()
    for d in (spill, twin):
        d.pages.write(d._rows(ids), {"sig": sigs, "norms": norms})
    if device == "cuda":
        torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    c1 = spill_counters()
    q_ids = [f"s{i}" for i in rng.integers(0, rows, SPILL_READS)]
    q_dat = nn_datums(np, rng, SPILL_READS)
    routes = [(lambda d, i=i: d.similar_row_from_id(i, NN_SIZE))
              for i in q_ids] + \
        [(lambda d, q=q: d.similar_row_from_datum(nn_datum(Datum, q),
                                                  NN_SIZE)) for q in q_dat]
    occupied = int((spill.pages._page_occ_vec() > 0).sum())
    per_read = 1 + -(-(occupied - budget)
                     // max(1, P.SPILL_CHUNK_ROWS // SPILL_PAGE_ROWS))
    before = launch_counts()
    with Checked(torch, L, "sig_scores", L.sig_scores_ref, 6) as chk:
        for read in routes:
            a, b = read(spill), read(twin)
            if not tie_eq(a, b):
                raise AssertionError(f"spill {name}: a read differs from "
                                     f"the resident twin's: {a} {b}")
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads(f"spill {name}", delta, len(routes) * per_read,
                    "sig_scores")
        if chk.calls != len(routes) * per_read:
            raise AssertionError(f"spill {name}: {chk.calls} launches "
                                 "checked")
    c2 = spill_counters()
    lat = timed_reads(np, [lambda r=r: r(spill) for r in routes])
    twin_lat = timed_reads(np, [lambda r=r: r(twin) for r in routes])
    q_sig = spill.pages.read("sig", [0])
    split = spill_split(torch, np, P, spill.pages,
                        lambda q, t: P.sig_scores(spill.pages, "lsh", 64,
                                                  q_sig, [1.0],
                                                  timing=t)[0],
                        range(SPILL_SPLITS), device)
    out = {"cell": name, "rows": rows, "page_rows": SPILL_PAGE_ROWS,
           "resident_pages": budget, "fill_s": fill_s,
           "read_ms_p50": pct(np, lat, 50), "read_ms_p99": pct(np, lat, 99),
           "twin_read_ms_p50": pct(np, twin_lat, 50),
           "twin_read_ms_p99": pct(np, twin_lat, 99),
           "launches_a_read": per_read, "split_ms": split,
           "device_bytes": spill.pages.device_bytes(),
           "twin_device_bytes": twin.pages.device_bytes(),
           "page_spill_in_total": {"fill": c1[0] - c0[0],
                                   "reads": c2[0] - c1[0]},
           "page_spill_out_total": {"fill": c1[1] - c0[1],
                                    "reads": c2[1] - c1[1]},
           "pages_resident": spill.get_status()["pages_resident"]}
    log("spill_nn " + json.dumps(out))
    del spill, twin
    if device == "cuda":
        torch.cuda.empty_cache()
    return delta, out


def spill_reco_cell(torch, np, device="cuda"):
    """Phase 13c: the recommender's inverted_index of phase 12b (IVF_CONFIG:
    Kr 32, 4,096 columns) at SPILL_RECO_ROWS rows, SPILL_RECO_BUDGET pages
    resident, filled as phase 12b fills it (host rows, one store write),
    and its resident twin; SPILL_READS reads of each route, every answer
    the twin's within rtol 1e-6 (the spilled score is the JAX driver's
    host arithmetic on the dots) and every K4 dense_dots launch, on the
    pool and on each chunk, bitwise its plain version; then timed, and a
    read's split."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.ops import paged as P
    rng = np.random.default_rng(91)
    cfg = dict(IVF_CONFIG, pages={"page_rows": SPILL_PAGE_ROWS,
                                  "resident_pages": SPILL_RECO_BUDGET})
    spill = create_driver("recommender", cfg, device=device)
    twin = create_driver("recommender", IVF_CONFIG, device=device)
    protos = [d for d in nn_datums(np, rng, 2 * INDEX_PROTOS)
              if len(spill.converter.convert_row(nn_datum(Datum, d)))
              == NN_NNZ][:INDEX_PROTOS]
    rows = ivf_rows(np, rng, spill, SPILL_RECO_ROWS, protos)
    ids = list(rows)
    c0 = spill_counters()
    t0 = time.perf_counter()
    for d in (spill, twin):
        slots = d.pages.alloc_seq(len(ids)).tolist()
        d.ids = dict(zip(ids, slots))
        d.row_ids = list(ids)
        d.rows = dict(rows)
        d._dirty = dict.fromkeys(ids, True)
        d._sync()
    if device == "cuda":
        torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    c1 = spill_counters()
    q_ids = [f"e{i}" for i in rng.integers(0, SPILL_RECO_ROWS, SPILL_READS)]
    q_dat = []
    for p in rng.integers(0, len(protos), SPILL_READS):
        names, vals = protos[p]
        q_dat.append((names, (np.asarray(vals) + 0.05 * rng.standard_normal(
            NN_NNZ)).tolist()))
    routes = [(lambda d, i=i: d.similar_row_from_id(i, NN_SIZE))
              for i in q_ids] + \
        [(lambda d, q=q: d.similar_row_from_datum(nn_datum(Datum, q),
                                                  NN_SIZE)) for q in q_dat]
    occupied = int((spill.pages._page_occ_vec() > 0).sum())
    per_read = 1 + -(-(occupied - SPILL_RECO_BUDGET)
                     // max(1, P.SPILL_CHUNK_ROWS // SPILL_PAGE_ROWS))
    before = launch_counts()
    with Checked(torch, L, "dense_dots", L.dense_dots_ref, 3) as chk:
        for read in routes:
            a, b = read(spill), read(twin)
            if not tie_eq(a, b, tol=1e-6):
                raise AssertionError("spill c: a recommender read differs "
                                     f"from the resident twin's: {a} {b}")
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads("spill c", delta, len(routes) * per_read, "dense_dots")
        if chk.calls != len(routes) * per_read:
            raise AssertionError(f"spill c: {chk.calls} launches checked")
    c2 = spill_counters()
    lat = timed_reads(np, [lambda r=r: r(spill) for r in routes])
    twin_lat = timed_reads(np, [lambda r=r: r(twin) for r in routes])
    qs = [spill._query_row(spill.rows[i]) for i in q_ids[:SPILL_SPLITS]]
    split = spill_split(torch, np, P, spill.pages,
                        lambda q, t: P.dense_scores(spill.pages, "cosine",
                                                    q[0], q[1], timing=t),
                        qs, device)
    out = {"cell": "c", "rows": SPILL_RECO_ROWS,
           "page_rows": SPILL_PAGE_ROWS,
           "resident_pages": SPILL_RECO_BUDGET, "kr": spill.kr,
           "fill_s": fill_s, "read_ms_p50": pct(np, lat, 50),
           "read_ms_p99": pct(np, lat, 99),
           "twin_read_ms_p50": pct(np, twin_lat, 50),
           "twin_read_ms_p99": pct(np, twin_lat, 99),
           "launches_a_read": per_read, "split_ms": split,
           "device_bytes": spill.pages.device_bytes(),
           "twin_device_bytes": twin.pages.device_bytes(),
           "page_spill_in_total": {"fill": c1[0] - c0[0],
                                   "reads": c2[0] - c1[0]},
           "page_spill_out_total": {"fill": c1[1] - c0[1],
                                    "reads": c2[1] - c1[1]}}
    log("spill_reco " + json.dumps(out))
    del spill, twin
    if device == "cuda":
        torch.cuda.empty_cache()
    return delta, out


def spill_anomaly(torch, np, device="cuda"):
    """Phase 13d: anomaly lof over euclid_lsh H 64 (LOF_CONFIG) with a
    quarter of its pages resident, SPILL_ANOM_ADDS adds and
    SPILL_ANOM_READS calc_score reads on the card, every score bitwise a
    CPU driver's fed the same datums (its signatures from K1 on the card,
    bitwise the plain version's, phases 10-11: the plain K1 takes about 30
    ms a datum on the host); every K5 scores launch bitwise its plain
    version."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    pages = -(-SPILL_ANOM_ADDS // SPILL_PAGE_ROWS)
    cfg = dict(LOF_CONFIG, pages={"page_rows": SPILL_PAGE_ROWS,
                                  "resident_pages": max(1, pages // 4)})
    card = create_driver("anomaly", cfg, device=device)
    cpu = create_driver("anomaly", cfg, device="cpu")
    rng = np.random.default_rng(101)
    data = row_datums(np, rng, SPILL_ANOM_ADDS + SPILL_ANOM_READS, 1024)
    orig = L.signature

    def card_signature(key, idx, val, h, kind, padded_b=None):
        if idx.device.type == "cpu" and device == "cuda":
            return orig(key, idx.cuda(), val.cuda(), h, kind,
                        padded_b).cpu()
        return orig(key, idx, val, h, kind, padded_b)

    before = launch_counts()
    t0 = time.perf_counter()
    L.signature = card_signature
    try:
        with Checked(torch, L, "sig_scores", L.sig_scores_ref, 6) as chk:
            for i, d in enumerate(data[:SPILL_ANOM_ADDS]):
                a = card.add(f"a{i}", nn_datum(Datum, d))
                b = cpu.add(f"a{i}", nn_datum(Datum, d))
                if a != b:
                    raise AssertionError(f"spill d: add {i} scores {a} on "
                                         f"the card, {b} on the CPU")
            for d in data[SPILL_ANOM_ADDS:]:
                if card.calc_score(nn_datum(Datum, d)) != \
                        cpu.calc_score(nn_datum(Datum, d)):
                    raise AssertionError("spill d: a calc_score differs")
    finally:
        L.signature = orig
    add_s = time.perf_counter() - t0
    delta = launch_delta(before, launch_counts())
    if device == "cuda" and (delta.get("sig_scores", 0) < SPILL_ANOM_ADDS
                             or chk.calls != delta["sig_scores"]):
        raise AssertionError(f"spill d: {delta.get('sig_scores')} K5 scores "
                             f"launches, {chk.calls} checked")
    st = card.get_status()
    log(f"spill_anomaly: lof euclid_lsh H 64, {SPILL_ANOM_ADDS} adds and "
        f"{SPILL_ANOM_READS} calc_scores in {add_s:.1f} s (both drivers), "
        f"every score bitwise the CPU driver's; pages {st['pages']}, "
        f"resident {st['pages_resident']} of "
        f"{st['resident_budget_pages']}; K5 scores launches "
        f"{delta.get('sig_scores', 0)}, each bitwise its plain version")
    return delta


def spill_wire(torch, np, device="cuda"):
    """Phase 13e: over the wire, a nearest_neighbor server (NN_CONFIG) with
    a spill config (SPILL_WIRE_BUDGET pages of 128 resident, a quarter of
    the table): SPILL_WIRE_ROWS set_rows (INDEX_WINDOW in flight while an
    in-process driver of the same config takes them), then
    SPILL_WIRE_READS reads, every answer bitwise the in-process driver's;
    get_status's page keys and the spill counters.  Returns the server's
    launches."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    cfg = dict(NN_CONFIG, pages={"page_rows": SPILL_PAGE_ROWS,
                                 "resident_pages": SPILL_WIRE_BUDGET})
    drv = create_driver("nearest_neighbor", cfg, device=device)
    rng = np.random.default_rng(111)
    data = nn_datums(np, rng, SPILL_WIRE_ROWS + SPILL_WIRE_READS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "spill.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        child, t0 = start_server("nearest_neighbor", cfg_path, tmp,
                                 device=device)
        try:
            port, _ = server_ready(child, t0)
            cli = WireClient(port)
            t0 = time.perf_counter()
            for w0 in range(0, SPILL_WIRE_ROWS, INDEX_WINDOW):
                win = range(w0, min(w0 + INDEX_WINDOW, SPILL_WIRE_ROWS))
                cli.sock.sendall(b"".join(
                    cli.frame("set_row", f"w{i}", nn_wire(data[i]))
                    for i in win))
                for i in win:
                    drv.set_row(f"w{i}", nn_datum(Datum, data[i]))
                for _ in win:
                    if cli.receive() is not True:
                        raise AssertionError("spill wire: set_row failed")
            write_s = time.perf_counter() - t0
            s0 = launches_of(status_of(cli))
            t0 = time.perf_counter()
            for j, d in enumerate(data[SPILL_WIRE_ROWS:]):
                if j % 2:
                    rid = f"w{int(rng.integers(0, SPILL_WIRE_ROWS))}"
                    a = cli.call("similar_row_from_id", rid, NN_SIZE)
                    b = drv.similar_row_from_id(rid, NN_SIZE)
                else:
                    a = cli.call("similar_row_from_datum", nn_wire(d),
                                 NN_SIZE)
                    b = drv.similar_row_from_datum(nn_datum(Datum, d),
                                                   NN_SIZE)
                if [tuple(x) for x in a] != [tuple(x) for x in b]:
                    raise AssertionError("spill wire: a read differs from "
                                         "the in-process driver's")
            read_s = time.perf_counter() - t0
            st = status_of(cli)
            sdelta = launch_delta(s0, launches_of(st))
            if device == "cuda" and sdelta.get("sig_scores", 0) < \
                    2 * SPILL_WIRE_READS:
                raise AssertionError(f"spill wire: the server's reads "
                                     f"launched K5 scores "
                                     f"{sdelta.get('sig_scores')} times")
            want = {"resident_budget_pages": str(SPILL_WIRE_BUDGET),
                    "pages_resident": str(SPILL_WIRE_BUDGET),
                    "page_rows": str(SPILL_PAGE_ROWS)}
            if any(st.get(k) != v for k, v in want.items()) or \
                    float(st.get("page_spill_in_total", 0)) <= 0 or \
                    float(st.get("page_spill_out_total", 0)) <= 0:
                raise AssertionError(f"spill wire: get_status page keys {st}")
            served = launches_of(st)
        finally:
            child.stop()
    log(f"spill wire: nearest_neighbor resident_pages {SPILL_WIRE_BUDGET}: "
        f"{SPILL_WIRE_ROWS} set_rows in {write_s:.1f} s (both sides), "
        f"{SPILL_WIRE_READS} reads in {read_s:.2f} s, bitwise the in-process "
        "driver; status " + ", ".join(
            f"{k}={st[k]}" for k in ("pages", "pages_resident",
                                     "resident_budget_pages",
                                     "page_spill_in_total",
                                     "page_spill_out_total")))
    return served


def sig_scores_row(torch, np, device="cuda"):
    """K5's scores mode at a streamed chunk's shape (lsh H 64, a chunk of
    SPILL_CHUNK_ROWS rows) at 1 and 64 queries and at cell (b)'s pool
    (1,953 pages of 128 rows, 1 query): bitwise its plain version, timed
    beside it, torch.cdist(p=0) and the bound by class (K5's: the bytes
    of its counts, the scores being as wide)."""
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.ops import paged as P
    dev = torch.device(device)
    h, kind = 64, "lsh"
    w = L.sig_width(kind, h)
    rg = np.random.default_rng(7)
    rows = []
    for r, nq in ((P.SPILL_CHUNK_ROWS, 1), (P.SPILL_CHUNK_ROWS, 64),
                  (SPILL_NN_CELLS[1][2] * SPILL_PAGE_ROWS, 1)):
        tab = torch.from_numpy(rg.integers(0, 2 ** 32, (r, w),
                                           dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(dev)
        norms = torch.ones(r, device=dev)
        xr = cdist_layout(torch, kind, h, tab) if device == "cuda" else None
        qs = tab[torch.from_numpy(rg.integers(0, r, nq)).to(dev)].clone()
        qs[:, 0] ^= 3
        qn = torch.ones(nq, device=dev)
        got = one_launch(L.sig_scores, kind, tab, qs, norms, qn, h)
        if not torch.equal(got.view(torch.int32), L.sig_scores_ref(
                kind, tab, qs, norms, qn, h).view(torch.int32)):
            raise AssertionError("spill: sig_scores differs from its plain "
                                 "version")
        lib = None
        if device == "cuda":
            xq = cdist_layout(torch, kind, h, qs)

            def lib(xq=xq, xr=xr):
                return torch.cdist(xq, xr, p=0)
        row = kernel_row(
            torch, lambda: L.sig_scores(kind, tab, qs, norms, qn, h),
            lambda: L.sig_scores_ref(kind, tab, qs, norms, qn, h), device, 2,
            lib=lib, lib_calls=2, classes=counts_bound(kind, r, w, nq),
            shape=[r, w, nq], err=0.0)
        row.update(kind=kind, hash_num=h, library="torch.cdist(p=0)")
        rows.append(row)
        del tab, norms, xr
    return dict(rows[0], variants=rows[1:])


def spill_dots_rows(torch, np, device="cuda"):
    """K4 dense_dots at cell (c)'s shapes (Kr 32, D 4096, one query): a
    streamed chunk of SPILL_CHUNK_ROWS rows and the pool's 488 pages of
    128 rows, bitwise its plain version, timed beside it, torch.sparse.mm
    and the bytes bound (as phase 11's rows)."""
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.ops import paged as P
    dev = torch.device(device)
    kr, d = 32, 4096
    out = []
    for r in (P.SPILL_CHUNK_ROWS, SPILL_RECO_BUDGET * SPILL_PAGE_ROWS):
        i2, v2, _ = sparse_rows(torch, np, dev, r, kr, d, 29)
        q2 = torch.from_numpy(np.random.default_rng(r).standard_normal(
            (1, d)).astype(np.float32)).to(dev)
        got = one_launch(L.dense_dots, i2, v2, q2)
        if not torch.equal(got.view(torch.int32),
                           L.dense_dots_ref(i2, v2, q2).view(torch.int32)):
            raise AssertionError("spill: dense_dots differs from its plain "
                                 "version")
        lib = None
        if device == "cuda":
            crow = torch.arange(0, r * kr + 1, kr, device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")       # CSR's beta notice
                csr = torch.sparse_csr_tensor(crow, i2.reshape(-1).long(),
                                              v2.reshape(-1), (r, d),
                                              check_invariants=False)
            qt = q2.T.contiguous()

            def lib(csr=csr, qt=qt):
                return torch.sparse.mm(csr, qt)
        nbytes = r * kr * 8 + gathered_query_bytes(torch, i2, 1) + r * 4
        out.append(dict(kernel_row(
            torch, lambda: L.dense_dots(i2, v2, q2),
            lambda: L.dense_dots_ref(i2, v2, q2), device, 1, lib=lib,
            classes={"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "f32": r * kr * 2 / F32_OPS_PER_S * 1e3},
            shape=[r, kr, d, 1], err=0.0), route="spill"))
    return out


# phase 14: the partition plane
PART_QUERIES = 64          # stored rows read back through their payloads
PART_WIRE_ROWS = 4096      # set_row / update_row calls through the proxy
                           # (16,384 before phase 15 came, 8,192 before
                           # phase 16)
PART_CONNS = 16            # client connections writing at once (the proxy
PART_WINDOW = 16           # serves a connection's requests in order), each
#                            with this many requests in flight
PART_READS = 64            # reads of each form through the proxy (256
                           # before phase 15 came, 128 before phase 16)
PART_ANOM_ROWS = 256       # anomaly rows over 2 ring partitions
PART_ANOM_READS = 64       # calc_score_partial queries
PART_GRACE = "1.5"         # --partition_handoff_grace of the servers
PART_RECO_CONFIG = {       # bench.py:914-919: 1,024 columns
    "method": "inverted_index", "parameter": {},
    "converter": {"num_rules": [{"key": "*", "type": "num"}],
                  "hash_max_size": 1024},
}


def tie_equal(got, want, ascending=False):
    """Scores equal in order; ids equal away from the k-th score (where a
    tie may name another member: the merge breaks ties by id, one sweep
    by row slot)."""
    got = [(str(i), float(s)) for i, s in got]
    want = [(str(i), float(s)) for i, s in want]
    if [s for _, s in got] != [s for _, s in want]:
        return False
    if not want:
        return True
    kth = want[-1][1]
    inner = (lambda s: s < kth) if ascending else (lambda s: s > kth)
    return sorted(t for t in got if inner(t[1])) == \
        sorted(t for t in want if inner(t[1]))


def phase_partition_local(torch, np, nn_drv, ivf_drv, device="cuda"):
    """Phase 14a: the *_partial legs in process on phase 12's tables (no
    new build).  PART_QUERIES stored rows of the 10^6-row lsh H 64 table:
    each row's payload (partition_query_sig: its signature's bytes and
    norm) through similar_row_from_sig_partial, once with lsh_probe (one
    K6 launch with q_sigs a read) and once with the index set aside (one
    K3 launch with q_sigs a read), each answer similar_row_from_id's of
    the same row; then PART_QUERIES rows of the 250,000-row inverted_index
    table, each row's partition_query_fv through
    similar_row_from_fv_partial with ivf (K7) and with the full sweep
    (K4), as bench.py:1265-1329 reads.  Every read's answer is its plain
    version's decoded, and the kernels' results (the reads' queries in one
    comparison launch for K3, K4 and K6, one a query for K7) bitwise the
    plain versions on the same card tensors.  Returns the partial reads'
    launches."""
    from jubatus_tpu_torch.fv import SparseBatch
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(141)
    counts = {}
    out = {}

    def partial_reads(drv, what, reads, kern, fb_kern):
        """Run the reads with the driver's index, then with it set aside:
        {route: (answers, ms a read)}, the launches checked and kept."""
        res = {}
        for route in ("index", "full"):
            saved = drv.index
            if route == "full":
                drv.index = None
            try:
                fb0 = float(metrics_snapshot().get("index_fallback_total",
                                                   "0"))
                before = launch_counts()
                t0 = time.perf_counter()
                got = [read() for read in reads]
                if device == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / len(reads)
                delta = launch_delta(before, launch_counts())
                fb = int(float(metrics_snapshot().get(
                    "index_fallback_total", "0")) - fb0)
            finally:
                drv.index = saved
            if device == "cuda":
                if route == "index":
                    check_reads(f"{what} (index)", delta, len(reads), kern)
                    check_reads(f"{what} (fallbacks)", delta, fb, fb_kern)
                else:
                    check_reads(f"{what} (full)", delta, len(reads),
                                fb_kern)
            for k, v in delta.items():
                counts[k] = counts.get(k, 0) + v
            res[route] = (got, ms, fb)
        return res

    # nearest_neighbor: K6 and K3 with q_sigs
    q_ids = [f"r{i}" for i in rng.integers(0, len(nn_drv.ids),
                                           PART_QUERIES)]
    payloads = [nn_drv.partition_query_sig(i) for i in q_ids]
    res = partial_reads(
        nn_drv, "partition nn",
        [lambda p=p: nn_drv.similar_row_from_sig_partial(p[0], p[1],
                                                         NN_SIZE)
         for p in payloads], "sig_probe", "sig_topk")
    idx = nn_drv._index_for_query()
    want = {"index": [nn_drv.similar_row_from_id(i, NN_SIZE)
                      for i in q_ids]}
    saved, nn_drv.index = nn_drv.index, None
    try:
        want["full"] = [nn_drv.similar_row_from_id(i, NN_SIZE)
                        for i in q_ids]
    finally:
        nn_drv.index = saved
    for route in ("index", "full"):
        if res[route][0] != want[route]:
            raise AssertionError(f"partition nn: a {route} partial read "
                                 "differs from similar_row_from_id")
    table, norms = nn_drv.sig, nn_drv.norms
    dev = table.device
    nv, mask = nn_drv._valid()
    q_sigs = torch.cat([L.sig_query_args(np.frombuffer(p[0], np.uint32),
                                         p[1], dev)[0] for p in payloads])
    qn = torch.tensor([np.float32(p[1]) for p in payloads],
                      dtype=torch.float32, device=dev)
    csr = idx.device_csr()
    kb6 = C._kb(NN_SIZE, idx.plan, csr[4], csr[3])
    k6 = C.sig_probe("lsh", table, norms, nv, mask, csr, idx.plan, idx.bits,
                     64, kb6, q_sigs=q_sigs, qnorms=qn)
    k6_ref = C.sig_probe_ref("lsh", table, norms, nv, mask, q_sigs, qn,
                             *csr[:4], csr[4], idx.plan, idx.bits, 64, kb6)
    k3 = L.sig_topk("lsh", table, norms, nv, q_sigs=q_sigs, qnorms=qn,
                    hash_num=64, kb=NN_KB, mask=mask)
    k3_ref = L.sig_topk_ref("lsh", table, norms, nv, q_sigs, qn, 64, NN_KB,
                            mask)
    if not (torch.equal(k6, k6_ref) and torch.equal(k3, k3_ref)):
        raise AssertionError("partition nn: K6 or K3 with q_sigs differs "
                             "from its plain version")
    rows3, scores3 = L.keys_to_host(k3_ref)
    rows6, scores6, _ = C.probe_result(k6_ref, kb6)
    for i, (a_idx, a_full) in enumerate(zip(res["index"][0],
                                            res["full"][0])):
        plain_full = nn_drv._to_results(rows3[i], scores3[i], NN_SIZE, True)
        r, sc = C.dedupe_topk(rows6[i], scores6[i], NN_SIZE)
        plain_idx = nn_drv._to_results(r, sc, NN_SIZE, True)
        if len(plain_idx) < min(NN_SIZE, len(nn_drv.ids)):
            plain_idx = plain_full          # an under-filled probe falls back
        if a_full != plain_full or a_idx != plain_idx:
            raise AssertionError("partition nn: a partial read is not its "
                                 "plain version's answer")
    out["nn"] = {"k6_ms": res["index"][1], "k3_ms": res["full"][1],
                 "fallbacks": res["index"][2]}
    # the recommender: K7 and K4 with the stored row as the query
    q_ids = [f"e{i}" for i in rng.integers(0, len(ivf_drv.ids),
                                           PART_QUERIES)]
    fvs = [ivf_drv.partition_query_fv(i) for i in q_ids]
    res = partial_reads(
        ivf_drv, "partition ivf",
        [lambda fv=fv: ivf_drv.similar_row_from_fv_partial(fv, NN_SIZE)
         for fv in fvs], "ivf_probe", "dense_topk")
    want = {"index": [ivf_drv.similar_row_from_id(i, NN_SIZE)
                      for i in q_ids]}
    saved, ivf_drv.index = ivf_drv.index, None
    try:
        want["full"] = [ivf_drv.similar_row_from_id(i, NN_SIZE)
                        for i in q_ids]
    finally:
        ivf_drv.index = saved
    for route in ("index", "full"):
        if res[route][0] != want[route]:
            raise AssertionError(f"partition ivf: a {route} partial read "
                                 "differs from similar_row_from_id")
    idx = ivf_drv._index_for_query()
    t = ivf_drv._sync()
    csr, cent = idx.device_csr(), idx.device_centroids()
    probes = min(INDEX_PROBES, cent.shape[0])
    kb7 = C._ivf_kb(NN_SIZE, probes, csr[4], csr[3])
    qs = [{int(i): float(v) for i, v in fv} for fv in fvs]
    dense = np.stack([ivf_drv._query_row(q)[0] for q in qs])
    qns = [ivf_drv._query_row(q)[1] for q in qs]
    qd_t = L._host(dense, np.float32, t["norms"].device)
    qn_t = L._host(qns, np.float32, t["norms"].device)
    kb4 = L._kb(NN_SIZE, t["rows"])
    k4 = L.dense_topk("cosine", t["indices"], t["values"], t["norms"],
                      t["rows"], t["mask"], qd_t, qn_t, kb4)
    k4_ref = L.dense_topk_ref("cosine", t["indices"], t["values"],
                              t["norms"], t["rows"], t["mask"], qd_t, qn_t,
                              kb4)
    if not torch.equal(k4, k4_ref):
        raise AssertionError("partition ivf: K4 differs from its plain "
                             "version")
    rows4, scores4 = L.keys_to_host(k4_ref)
    for i, q in enumerate(qs):
        b = SparseBatch.from_rows([q])
        dev = t["norms"].device
        qargs = (L._host(b.indices[0], np.int32, dev),
                 L._host(b.values[0], np.float32, dev), qd_t[i])
        # the pruned route's norm: the host's float64 sum (_similar_pruned)
        qn7 = float(np.sqrt(sum(v * v for v in q.values())))
        k7 = C.ivf_probe("cosine", *qargs, qn7, cent, t["indices"],
                         t["values"], t["norms"], t["rows"], t["mask"], csr,
                         probes, idx.embed_dim, kb7)
        k7_ref = C.ivf_probe_ref(
            "cosine", *qargs, torch.tensor(np.float32(qn7), device=dev),
            cent, t["indices"], t["values"], t["norms"], t["rows"],
            t["mask"], *csr[:4], csr[4], probes, idx.embed_dim, kb7)
        if not torch.equal(k7, k7_ref):
            raise AssertionError("partition ivf: K7 differs from its plain "
                                 "version")
        r, sc, _ = C.probe_result(k7_ref, kb7)
        r, sc = C.dedupe_topk(r[0], sc[0], NN_SIZE)
        plain_full = ivf_drv._trim_results(rows4[i], scores4[i], NN_SIZE)
        plain_idx = ivf_drv._trim_results(r, sc, NN_SIZE)
        if len(plain_idx) < min(NN_SIZE, len(ivf_drv.ids)):
            plain_idx = plain_full
        if res["full"][0][i] != plain_full or res["index"][0][i] != plain_idx:
            raise AssertionError("partition ivf: a partial read is not its "
                                 "plain version's answer")
    out["reco"] = {"k7_ms": res["index"][1], "k4_ms": res["full"][1],
                   "fallbacks": res["index"][2]}
    log(f"partition local: {PART_QUERIES} payload reads a route; nn lsh "
        f"H 64 at {len(nn_drv.ids)} rows: K6 (q_sigs) {out['nn']['k6_ms']:.3f}"
        f" ms a read ({out['nn']['fallbacks']} fallbacks), K3 (q_sigs) "
        f"{out['nn']['k3_ms']:.3f} ms; inverted_index at {len(ivf_drv.ids)} "
        f"rows: K7 {out['reco']['k7_ms']:.3f} ms a read "
        f"({out['reco']['fallbacks']} fallbacks), K4 "
        f"{out['reco']['k4_ms']:.3f} ms; each equal to similar_row_from_id, "
        "bitwise the plain versions")
    return counts


def part_children(service, cfg, tmp, addr, name, n, device):
    """n partition servers of `service` and a port proxy over them, all
    started at once: (servers, proxy, their start time)."""
    cfg_path = os.path.join(tmp, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    servers = [part_server(service, cfg_path, tmp, addr, name, device)
               for _ in range(n)]
    proxy = Child(["jubatus_tpu_torch.cli.proxy", "--type", service,
                   "--coordinator", addr, "--rpc-port", "0",
                   "--listen_addr", "127.0.0.1", "--routing", "partition",
                   "--thread", "16"])
    return servers, proxy, t0, cfg_path


def part_server(service, cfg_path, tmp, addr, name, device):
    return start_server(service, cfg_path, tmp, "--name", name,
                        "--coordinator", addr, "--routing", "partition",
                        "--interval_sec", "100000", "--interval_count",
                        "100000000", "--partition_handoff_interval", "0.2",
                        "--partition_handoff_grace", PART_GRACE,
                        device=device)[0]


def part_write(port, name, write, data, ids, side):
    """Every write through the proxy at `port`: PART_CONNS connections on
    threads, PART_WINDOW requests in flight on each; `side()` runs on
    this thread meanwhile (the in-process table's own writes).  -> the
    wire writes' seconds."""
    import threading
    errs = []
    done = {}

    def run(k):
        cli = WireClient(port, name)
        try:
            step = PART_CONNS * PART_WINDOW
            for w0 in range(k * PART_WINDOW, len(ids), step):
                win = range(w0, min(w0 + PART_WINDOW, len(ids)))
                cli.sock.sendall(b"".join(
                    cli.frame(write, ids[i], nn_wire(data[i])) for i in win))
                for _ in win:
                    if cli.receive() is not True:
                        raise AssertionError(f"partition wire: a {write} "
                                             "failed")
            done[k] = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
        finally:
            cli.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(k,))
               for k in range(PART_CONNS)]
    for t in threads:
        t.start()
    side()
    for t in threads:
        t.join(timeout=600)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("partition wire: a writer thread hung")
    return max(done.values()) - t0


def part_reads(cli, forms):
    """forms: {name: [(method, *args), ...]} -> {name: (answers, [ms])},
    each read timed alone on the host clock."""
    out = {}
    for name, calls in forms.items():
        answers, lat = [], []
        for call in calls:
            t0 = time.perf_counter()
            answers.append(cli.call(*call))
            lat.append((time.perf_counter() - t0) * 1e3)
        out[name] = (answers, lat)
    return out


def p50_p99(np, lat):
    return [round(pct(np, lat, q), 3) for q in (50, 99)]


def phase_partition_wire(torch, np, device="cuda"):
    """Phase 14b: over the wire on the card, the port's coordinator and a
    nearest_neighbor cluster (NN_CONFIG: lsh H 64, 4,096 columns) and a
    recommender cluster (PART_RECO_CONFIG) of --routing partition servers,
    each behind its own port proxy (cli/proxy.py --routing partition),
    started at once.  nearest_neighbor: PART_WIRE_ROWS set_rows through
    the proxy (each on its one ring owner: the servers' rows disjoint,
    summing to the total), PART_READS reads of each of the four read forms
    at 2 partitions, then a third server joins and the handoff runs (rows
    shipped a batch to their new owner, journal-less) until the
    partitions are disjoint and sum to the total, and the reads again at 3
    partitions.  The recommender: PART_WIRE_ROWS update_rows and
    PART_READS reads of similar_row_from_id and similar_row_from_datum.
    Every answer is the plain version's (sig_topk_ref, dense_topk_ref)
    over an in-process table that holds the same rows (written as the
    servers write them), scores exact and ids tie-aware.  Returns the
    server processes' launches."""
    from jubatus_tpu_torch.framework.partition import merge_topk
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(151)
    served = {}
    stats = {}
    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            coord = Child(["jubatus_tpu_torch.cluster.coordinator",
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1"])
            children.append(coord)
            addr = coord.wait_line("jubacoordinator", 120).split()[-1]
            clusters = {}
            for service, cfg, name in (
                    ("nearest_neighbor", NN_CONFIG, "part_nn"),
                    ("recommender", PART_RECO_CONFIG, "part_reco")):
                servers, proxy, t0, cfg_path = part_children(
                    service, cfg, tmp, addr, name, 2, device)
                children.extend(servers + [proxy])
                clusters[service] = (servers, proxy, t0, cfg_path, name)
            for service, (servers, proxy, t0, _, name) in clusters.items():
                for child in servers:
                    server_ready(child, t0)
                pport = int(proxy.wait_line("jubatus ready", 300).split()[2]
                            .split("=")[1])
                cli = WireClient(pport, name)
                cli.port = pport
                clusters[service] += (cli,)
            # nearest_neighbor: writes, reads at 2, the join, reads at 3
            servers, proxy, _, cfg_path, name, cli = \
                clusters["nearest_neighbor"]
            ref = create_driver("nearest_neighbor", NN_CONFIG, device=device)
            data = nn_datums(np, rng, PART_WIRE_ROWS + PART_READS)
            ids = [f"w{i}" for i in range(PART_WIRE_ROWS)]

            def ref_writes():
                for i in range(PART_WIRE_ROWS):
                    ref.set_row(ids[i], nn_datum(Datum, data[i]))
            write_s = part_write(cli.port, name,
                                 "set_row", data, ids, ref_writes)
            held = part_held(cli, servers, name)
            check_cover("partition nn (2)", held, ids)
            q_ids = [ids[i] for i in rng.integers(0, PART_WIRE_ROWS,
                                                  PART_READS)]
            q_dat = data[PART_WIRE_ROWS:]
            forms = nn_forms(q_ids, q_dat)
            want = nn_plain(torch, np, L, Datum, ref, q_ids, q_dat)
            got2 = part_reads(cli, forms)
            check_forms("partition nn (2)", got2, want)
            # the merge's host time: 2 servers' legs for one read
            legs = part_legs(part_ports(cli), name, q_ids[0])
            reps = 2000
            t0 = time.perf_counter()
            for _ in range(reps):
                merge_topk(legs, NN_SIZE, False)
            merge_ms = (time.perf_counter() - t0) * 1e3 / reps
            if [list(x) for x in merge_topk(legs, NN_SIZE, False)] != \
                    [list(x) for x in got2["similar_row_from_id"][0][0]]:
                raise AssertionError("partition nn: the proxy's merge is "
                                     "not the legs' merge")
            # the join
            third = part_server("nearest_neighbor", cfg_path, tmp, addr,
                                name, device)
            children.append(third)
            t_join = time.perf_counter()
            server_ready(third, t_join)
            ready_s = time.perf_counter() - t_join

            def converged():
                st = cli.call("get_status")
                rows = [int(v.get("partition_rows", 0)) for v in st.values()]
                if not (len(rows) == 3 and sum(rows) == PART_WIRE_ROWS
                        and all(rows)):
                    return False, st
                # the members answer get_status one after another, so
                # the sum can match mid-handoff (a row counted at neither
                # end, another at both): the layout itself must be done
                held = part_held(cli, servers + [third], name)
                return (all(held) and sum(map(len, held))
                        == len(set().union(*held)) == PART_WIRE_ROWS), st
            deadline = time.monotonic() + 120
            while True:
                ok, st = converged()
                if ok:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"partition nn: the handoff did not "
                                         f"converge: {st}")
                time.sleep(0.1)
            handoff_s = time.perf_counter() - t_join - ready_s
            held = part_held(cli, servers + [third], name)
            check_cover("partition nn (3)", held, ids)
            moved = sum(float(v.get("partition_handoff_rows_total", 0))
                        for v in st.values())
            moved_bytes = sum(float(v.get("partition_handoff_bytes_total",
                                          0)) for v in st.values())
            got3 = part_reads(cli, forms)
            check_forms("partition nn (3)", got3, want)
            for k, v in launches_of_all(cli.call("get_status")).items():
                served[k] = served.get(k, 0) + v
            stats["nn"] = {
                "rows": PART_WIRE_ROWS, "write_s": round(write_s, 3),
                "p2": {f: p50_p99(np, got2[f][1]) for f in forms},
                "p3": {f: p50_p99(np, got3[f][1]) for f in forms},
                "merge_ms": round(merge_ms, 4),
                "join_ready_s": round(ready_s, 3),
                "handoff_s": round(handoff_s, 3),
                "handoff_rows": moved, "handoff_bytes": moved_bytes,
                "handoff_rows_per_s": round(moved / max(handoff_s, 1e-9),
                                            1),
                "partition_rows": [len(h) for h in held]}
            # the recommender: writes and reads at 2 partitions
            servers, proxy, _, _, name, cli = clusters["recommender"]
            ref = create_driver("recommender", PART_RECO_CONFIG,
                                device=device)
            data = reco_datums(np, rng, PART_WIRE_ROWS + PART_READS)
            ids = [f"u{i}" for i in range(PART_WIRE_ROWS)]

            def ref_updates():
                for i in range(PART_WIRE_ROWS):
                    ref.update_row(ids[i], nn_datum(Datum, data[i]))
            write_s = part_write(cli.port, name,
                                 "update_row", data, ids, ref_updates)
            check_cover("partition reco", part_held(cli, servers, name), ids)
            q_ids = [ids[i] for i in rng.integers(0, PART_WIRE_ROWS,
                                                  PART_READS)]
            q_dat = data[PART_WIRE_ROWS:]
            forms = {"similar_row_from_id": [
                ("similar_row_from_id", i, NN_SIZE) for i in q_ids],
                "similar_row_from_datum": [
                ("similar_row_from_datum", nn_wire(d), NN_SIZE)
                for d in q_dat]}
            want = reco_plain(torch, np, L, Datum, ref, q_ids, q_dat)
            got = part_reads(cli, forms)
            check_forms("partition reco", got, want)
            for k, v in launches_of_all(cli.call("get_status")).items():
                served[k] = served.get(k, 0) + v
            stats["reco"] = {"rows": PART_WIRE_ROWS,
                             "write_s": round(write_s, 3),
                             "p2": {f: p50_p99(np, got[f][1]) for f in forms}}
        finally:
            for child in reversed(children):
                child.stop()
    if device == "cuda":
        for kern in ("lsh_signature", "sig_topk", "dense_topk"):
            if served.get(kern, 0) <= 0:
                raise AssertionError(f"partition wire: the servers never "
                                     f"launched {kern}")
    log(f"partition wire: {json.dumps(stats)}")
    return served


def part_legs(ports, name, id_):
    """similar_row_from_id's legs, asked of each member as the proxy asks
    them: the payload from the member that holds the row, then every
    member's similar_row_from_sig_partial with it."""
    clis = [WireClient(p, name) for p in ports]
    try:
        payload = None
        for c in clis:
            try:
                payload = c.call("partition_query_sig", id_)
                break
            except RuntimeError:            # not this member's row
                continue
        if payload is None:
            raise AssertionError(f"partition: no member holds {id_}")
        return [(i, c.call("similar_row_from_sig_partial", payload, NN_SIZE))
                for i, c in enumerate(clis)]
    finally:
        for c in clis:
            c.close()


def part_ports(cli):
    return [int(sid.rsplit("_", 1)[1]) for sid in cli.call("get_status")]


def part_held(cli, servers, name):
    """Each member's resident rows, asked of the member itself."""
    out = []
    for port in part_ports(cli):
        c = WireClient(port, name)
        try:
            out.append(set(c.call("get_all_rows")))
        finally:
            c.close()
    if len(out) != len(servers):
        raise AssertionError(f"partition: {len(out)} members answer, "
                             f"{len(servers)} started")
    return out


def check_cover(what, held, ids):
    seen = set()
    for rows in held:
        if not rows or not seen.isdisjoint(rows):
            raise AssertionError(f"{what}: a partition is empty or shares "
                                 "a row")
        seen |= rows
    if seen != set(ids):
        raise AssertionError(f"{what}: {len(set(ids) - seen)} rows lost")


def launches_of_all(statuses):
    out = {}
    for st in statuses.values():
        for k, v in launches_of(st).items():
            out[k] = out.get(k, 0) + v
    return out


def nn_forms(q_ids, q_dat):
    return {
        "neighbor_row_from_id": [("neighbor_row_from_id", i, NN_SIZE)
                                 for i in q_ids],
        "similar_row_from_id": [("similar_row_from_id", i, NN_SIZE)
                                for i in q_ids],
        "neighbor_row_from_datum": [("neighbor_row_from_datum", nn_wire(d),
                                     NN_SIZE) for d in q_dat],
        "similar_row_from_datum": [("similar_row_from_datum", nn_wire(d),
                                    NN_SIZE) for d in q_dat]}


def nn_plain(torch, np, L, Datum, ref, q_ids, q_dat):
    """Each read form's answers by the plain version (sig_topk_ref) over
    the reference table: {form: (answers, ascending)}."""
    table, norms = ref.sig, ref.norms
    nv, mask = ref._valid()
    dev = table.device
    rows_q = torch.tensor([ref.ids[i] for i in q_ids], device=dev)
    batch = ref.converter.convert_batch([nn_datum(Datum, d) for d in q_dat],
                                        update_weights=False)
    sigs = [ref._signature(ref.converter.convert_batch(
        [nn_datum(Datum, d)], update_weights=False))[0][0] for d in q_dat]
    q_sigs = L._host(np.stack(sigs).view(np.int32), np.int32, dev)
    qn = L._host(np.sqrt((batch.values * batch.values).sum(axis=1)),
                 np.float32, dev)
    out = {}
    for src, qs, qnorms in (("id", table[rows_q], norms[rows_q]),
                            ("datum", q_sigs, qn)):
        keys = L.sig_topk_ref("lsh", table, norms, nv, qs, qnorms, 64, NN_KB,
                              mask)
        rows, scores = L.keys_to_host(keys)
        for sim, asc in ((True, False), (False, True)):
            kind = "similar" if sim else "neighbor"
            out[f"{kind}_row_from_{src}"] = (
                [ref._to_results(rows[i], scores[i], NN_SIZE, sim)
                 for i in range(len(rows))], asc)
    return out


def reco_datums(np, rng, n):
    """bench.py:914-919's rows: 16 of 1,024 columns, standard normal
    values."""
    keys = rng.integers(0, 1024, (n, 16))
    vals = rng.standard_normal((n, 16))
    return [([f"c{k}" for k in ks], vs)
            for ks, vs in zip(keys.tolist(), vals.tolist())]


def reco_plain(torch, np, L, Datum, ref, q_ids, q_dat):
    t = ref._sync()
    dev = t["norms"].device
    out = {}
    for form, qs in (("similar_row_from_id", [ref.rows[i] for i in q_ids]),
                     ("similar_row_from_datum",
                      [ref.converter.convert_row(nn_datum(Datum, d))
                       for d in q_dat])):
        dense = np.stack([ref._query_row(q)[0] for q in qs])
        qn = [ref._query_row(q)[1] for q in qs]
        keys = L.dense_topk_ref("cosine", t["indices"], t["values"],
                                t["norms"], t["rows"], t["mask"],
                                L._host(dense, np.float32, dev),
                                L._host(qn, np.float32, dev),
                                L._kb(NN_SIZE, t["rows"]))
        rows, scores = L.keys_to_host(keys)
        out[form] = ([ref._trim_results(rows[i], scores[i], NN_SIZE)
                      for i in range(len(qs))], False)
    return out


def check_forms(what, got, want):
    for form, (answers, _lat) in got.items():
        plain, asc = want[form]
        for a, b in zip(answers, plain):
            if not tie_equal(a, b, asc):
                raise AssertionError(f"{what}: a {form} read through the "
                                     f"proxy is not the plain version's "
                                     f"answer over the whole table: {a} vs "
                                     f"{b}")


def phase_partition_anomaly(torch, np, device="cuda"):
    """Phase 14c: anomaly lof over euclid_lsh H 64 (LOF_CONFIG) in process
    over 2 ring partitions (a CHT ring of two nodes' 8 virtual points
    each; each row on its key's owner) and one driver that holds every
    row: PART_ANOM_ROWS rows, then PART_ANOM_READS queries' calc_score
    _partial legs (K1, then one K5 sig_counts launch a leg).  The merged
    kNN's ids and distances are the full table's; one partition's merge
    (the full driver's own leg) is bitwise its calc_score; each
    partition's K5 counts for all the queries bitwise the plain
    version's.  Returns the legs' launches."""
    from jubatus_tpu_torch.cluster.cht import CHT, NUM_VSERV, make_hash
    from jubatus_tpu_torch.framework.partition import merge_anomaly_score
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.ops import lsh as L
    rng = np.random.default_rng(161)
    t_start = time.perf_counter()
    nodes = [("127.0.0.1", 9301), ("127.0.0.1", 9302)]
    ring = sorted((make_hash(f"{h}_{p}_{i}"), (h, p)) for h, p in nodes
                  for i in range(NUM_VSERV))
    parts = [create_driver("anomaly", LOF_CONFIG, device=device)
             for _ in nodes]
    full = create_driver("anomaly", LOF_CONFIG, device=device)
    data = nn_datums(np, rng, PART_ANOM_ROWS + PART_ANOM_READS)
    for i in range(PART_ANOM_ROWS):
        id_ = f"a{i}"
        owner = CHT._walk(ring, id_, 1)[0]
        parts[nodes.index(owner)].update(id_, nn_datum(Datum, data[i]))
        full.update(id_, nn_datum(Datum, data[i]))
    if not all(p.ids for p in parts):
        raise AssertionError("partition anomaly: an empty ring partition")
    queries = [nn_datum(Datum, d) for d in data[PART_ANOM_ROWS:]]
    before = launch_counts()
    legs = [[(j, p.calc_score_partial(q)) for j, p in enumerate(parts)]
            for q in queries]
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads("partition anomaly", delta, 2 * len(queries),
                    "sig_counts")
    for q, leg in zip(queries, legs):
        one = full.calc_score_partial(q)
        if merge_anomaly_score([(0, one)]) != full.calc_score(q):
            raise AssertionError("partition anomaly: one partition's merge "
                                 "is not calc_score")
        merged = sorted((it for _, lg in leg for it in lg[2]),
                        key=lambda t: (t[1], t[0]))[:one[0]]
        if [c[1] for c in merged] != [c[1] for c in one[2]]:
            raise AssertionError("partition anomaly: the merged kNN's "
                                 "distances are not the full table's")
        merge_anomaly_score(leg)
    # K5 per partition, every query at once, against its plain version
    for p in parts:
        p._sync()
        table = p.pages.device("sig")
        norms = p.pages.device("norms")
        batch = p.converter.convert_batch(queries, update_weights=False)
        dev = table.device
        q_sigs = L.signature(p.key, L._host(batch.indices, np.int32, dev),
                             L._host(batch.values, np.float32, dev), 64,
                             "euclid_lsh")
        qn = L._host(np.sqrt((batch.values * batch.values).sum(axis=1)),
                     np.float32, dev)
        got = L.sig_counts("euclid_lsh", table, q_sigs, norms, qn, 64)
        ref = L.sig_counts_ref("euclid_lsh", table, q_sigs, norms, qn, 64)
        if not torch.equal(got, ref):
            raise AssertionError("partition anomaly: K5 differs from its "
                                 "plain version")
    log(f"partition anomaly: lof euclid_lsh H 64, {PART_ANOM_ROWS} rows over "
        f"2 ring partitions ({len(parts[0].ids)} + {len(parts[1].ids)}), "
        f"{len(queries)} calc_score_partial legs a partition: the merged "
        "kNN the full table's, one partition's merge bitwise calc_score, "
        f"K5 bitwise its plain version; {time.perf_counter() - t_start:.1f} s")
    return {k: delta.get(k, 0) for k in ("sig_counts", "lsh_signature")}


def phase_spill(torch, np, device="cuda"):
    """Phase 13: the spill tier.  Returns (the paths' launches, K5 scores
    mode's row, the cells' lines)."""
    t13 = time.perf_counter()
    row = sig_scores_row(torch, np, device)
    row["dots_variants"] = spill_dots_rows(torch, np, device)
    counts, cells = [], []
    for name, rows, budget in SPILL_NN_CELLS:
        delta, out = spill_nn_cell(torch, np, name, rows, budget, device)
        counts.append(delta)
        cells.append(out)
    delta, out = spill_reco_cell(torch, np, device)
    counts.append(delta)
    cells.append(out)
    counts.append(spill_anomaly(torch, np, device))
    counts.append(spill_wire(torch, np, device))
    log(f"spill: phase 13 in {time.perf_counter() - t13:.1f} s")
    return counts, row, cells


# ---------------------------------------------------------------------------
# 15. the operating plane: the train modes, the tracer, the exporter, the
# traced MIX round and proxy read, --torch_profile
# ---------------------------------------------------------------------------

# bench.py's bench_ingest_pipeline (bench.py:484-536) and
# bench_tracing_overhead (:539-552) shapes
OP_CLIENTS = 64
OP_REQS = 25               # train requests of each client
OP_ROWS = 4                # single-token datums a request
OP_READ_CLIENTS = 16
OP_READ_REQS = 25
OP_WINDOW = 32             # requests in flight on the sequential client
OP_MODES = {
    "per_request": ("--batch_max", "1", "--batch_window_us", "0",
                    "--ingest_depth", "0"),
    "batched": ("--ingest_depth", "0"),
    "pipelined": (),
    "inline": ("--dispatch", "inline"),
}
OP_TRACE = ("--trace_ring", "4096", "--slow_op_ms", "10000")
OP_STAGE_KEYS = ("rpc.train_total_sec", "convert_lock_wait_total_sec",
                 "ingest.convert_total_sec", "batch.train.step_total_sec",
                 "batch.train.size_mean", "ingest_pipeline_stall_total",
                 "ingest_pipeline", "dispatch_mode")
OP_PART_ROWS = 2048        # set_rows through the proxy at 2 partitions
OP_PART_READS = 64
OP_PROFILE_TRAINS = 8
OP_PROFILE_B = 1024
OP_PROFILE_READS = 32


def op_train_request(tid, r):
    """bench.py's _train_clients datums: OP_ROWS single-token datums,
    distinct per (client, request)."""
    return [[f"l{i % 8}", [[["w", f"t{tid}_{r}_{i}"]], [], []]]
            for i in range(OP_ROWS)]


def op_train_load(port):
    """OP_CLIENTS connections on threads, each a warm request, then
    OP_REQS train requests one at a time; the window closes with a
    classify (bench.py's fence).  -> samples/s."""
    import threading
    barrier = threading.Barrier(OP_CLIENTS + 1, timeout=600)
    errs = []

    def worker(tid):
        cli = WireClient(port)
        try:
            cli.call("train", op_train_request(tid, "warm"))
            barrier.wait()
            for r in range(OP_REQS):
                if cli.call("train", op_train_request(tid, r)) != OP_ROWS:
                    raise AssertionError("operating: a train was not acked")
            barrier.wait()
        except threading.BrokenBarrierError:
            pass
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
            barrier.abort()
        finally:
            cli.close()

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(OP_CLIENTS)]
    for t in threads:
        t.start()
    fence = WireClient(port)
    try:
        barrier.wait()
        t0 = time.perf_counter()
        barrier.wait()
        fence.call("classify", [[[["w", "t0_0_0"]], [], []]])
        dt = time.perf_counter() - t0
    except threading.BrokenBarrierError:
        dt = None
    finally:
        fence.close()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    return OP_CLIENTS * OP_REQS * OP_ROWS / dt


def op_sequential(port):
    """clear, then the load's requests (client-major) from ONE client in
    wire order, OP_WINDOW in flight."""
    cli = WireClient(port)
    try:
        if cli.call("clear") is not True:
            raise AssertionError("operating: clear failed")
        frames = [cli.frame("train", op_train_request(t, r))
                  for t in range(OP_CLIENTS) for r in range(OP_REQS)]
        for w0 in range(0, len(frames), OP_WINDOW):
            win = frames[w0:w0 + OP_WINDOW]
            cli.sock.sendall(b"".join(win))
            for _ in win:
                if cli.receive() != OP_ROWS:
                    raise AssertionError("operating: a sequential train "
                                         "was not acked")
        return cli.call("get_labels")
    finally:
        cli.close()


def op_classify_qps(np, port, datums):
    """OP_READ_CLIENTS connections, OP_READ_REQS one-datum classifies
    each, one at a time -> (qps, p50 ms)."""
    import threading
    lat, errs = [], []

    def worker(k):
        cli = WireClient(port)
        try:
            for r in range(OP_READ_REQS):
                d = datums[k * OP_READ_REQS + r]
                t0 = time.perf_counter()
                cli.call("classify", [d])
                lat.append((time.perf_counter() - t0) * 1e3)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
        finally:
            cli.close()

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(OP_READ_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return OP_READ_CLIENTS * OP_READ_REQS / dt, pct(np, lat, 50)


def op_scrape(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.read().decode()


def op_spans(spans, name):
    return [s for s in spans if s["name"] == name]


def phase_operating(torch, np, card, device="cuda"):
    """Phase 15: the operating plane on the card, its servers as
    subprocesses started at once.  (a) The four train modes
    (per-request, batched, pipelined, inline) at bench_ingest_pipeline's
    shape (OP_CLIENTS clients x OP_REQS requests x OP_ROWS rows,
    --thread 64), the smoke's sequential AROW config, so every mode
    launches train_scan: samples/s, the stage totals of get_status and
    the launches; then each server cleared and trained by one client on
    the same requests in wire order, and every model (a fifth server
    with the tracer on too) bitwise equal.  (b) Classify qps at
    bench_tracing_overhead's OP_READ_CLIENTS x OP_READ_REQS without and
    with `--trace_ring 4096 --slow_op_ms 10000`, in turns.  (c) A traced
    two-server --mix_quantize round: the applied mix.round span beside
    the smoke's wall time, its leg records, mix_bytes_* and the
    quantizer launches.  (d) A traced read through the port's proxy at 2
    partitions, split into proxy.forward, the members' rpc.* spans and
    proxy.partition_merge.  (e) The exporter's /metrics against
    get_metrics.  (f) A --torch_profile server: OP_PROFILE_TRAINS trains
    and OP_PROFILE_READS classifies, the trace naming train_scan, the
    trains' ms beside a server without the profiler.  On the CPU (a
    rehearsal) the launch and kernel-name checks are skipped.  -> the
    servers' kernel launches, summed."""
    from collections import Counter
    from contextlib import closing
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    launches = Counter()
    children = []
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "classifier.json")
        with open(cfg_path, "w") as f:
            json.dump(SERVER_CONFIG, f)
        nn_path = os.path.join(tmp, "nn.json")
        with open(nn_path, "w") as f:
            json.dump(NN_CONFIG, f)
        prof_dir = os.path.join(tmp, "profile")
        try:
            t0 = time.perf_counter()
            coord = Child(["jubatus_tpu_torch.cluster.coordinator",
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1"])
            children.append(coord)
            modes = {m: start_server("classifier", cfg_path, tmp, "--thread",
                                     str(OP_CLIENTS), *flags,
                                     device=device)[0]
                     for m, flags in OP_MODES.items() if m != "pipelined"}
            prof = start_server("classifier", cfg_path, tmp,
                                "--torch_profile", prof_dir,
                                device=device)[0]
            children.extend([*modes.values(), prof])
            addr = coord.wait_line("jubacoordinator", 120).split()[-1]
            # the pipelined server and the traced one (its flags and
            # the exporter beside the pipelined defaults) are also (c)'s
            # two-member v3 cluster; the trigger stays out of reach
            mix_flags = ("--name", "op_mix", "--coordinator", addr,
                         "--mix_quantize", "--interval_sec", "100000",
                         "--interval_count", "100000000")
            modes["pipelined"] = start_server(
                "classifier", cfg_path, tmp, "--thread", str(OP_CLIENTS),
                *mix_flags, device=device)[0]
            traced = start_server(
                "classifier", cfg_path, tmp, "--thread", str(OP_CLIENTS),
                *OP_TRACE, "--metrics_port", "-1", *mix_flags,
                device=device)[0]
            children.extend([modes["pipelined"], traced])
            parts = [start_server(
                "nearest_neighbor", nn_path, tmp, "--name", "op_part",
                "--coordinator", addr, "--routing", "partition",
                "--trace_ring", "8192", "--interval_sec", "100000",
                "--interval_count", "100000000", device=device)[0]
                for _ in range(2)]
            children.extend(parts)
            ready = {}
            for name, child in [*modes.items(), ("traced", traced),
                                ("profile", prof)] \
                    + [(f"part{i}", c) for i, c in enumerate(parts)]:
                line = child.wait_line("jubatus ready", 300).split()
                ready[name] = (int(line[2].split("=")[1]),
                               int(line[3].split("=")[1]))
            # the proxy after its members, with the tracer on
            proxy = Child(["jubatus_tpu_torch.cli.proxy", "--type",
                           "nearest_neighbor", "--coordinator", addr,
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                           "--routing", "partition", "--thread", "16",
                           "--trace_ring", "8192"])
            children.append(proxy)
            pport = int(proxy.wait_line("jubatus ready", 300).split()[2]
                        .split("=")[1])
            startup_s = time.perf_counter() - t0

            # (a) the four train modes
            modes_out = {}
            for mode in OP_MODES:
                port = ready[mode][0]
                sps = op_train_load(port)
                with closing(WireClient(port)) as cli:
                    st = status_of(cli)
                modes_out[mode] = {
                    "samples_per_s": round(sps, 1),
                    **{k: st.get(k) for k in OP_STAGE_KEYS},
                    "train_scan": launches_of(st).get("train_scan", 0)}
                if on_card and modes_out[mode]["train_scan"] <= 0:
                    raise AssertionError(f"operating: {mode} never launched "
                                         "train_scan")
            want_mode = {"per_request": ("threaded", "0"),
                         "batched": ("threaded", "0"),
                         "pipelined": ("threaded", "1"),
                         "inline": ("inline", "0")}
            for mode, (dm, ip) in want_mode.items():
                got = (modes_out[mode]["dispatch_mode"],
                       modes_out[mode]["ingest_pipeline"])
                if got != (dm, ip):
                    raise AssertionError(f"operating: {mode} reports "
                                         f"{got}, not {(dm, ip)}")
            labels = {}
            tables = {}
            for mode in [*OP_MODES, "traced"]:
                port = ready[mode][0]
                labels[mode] = op_sequential(port)
                if mode in OP_MODES:     # the traced one: (b)'s model
                    with closing(WireClient(port)) as cli:
                        tables[mode] = saved_tables(np, cli, "classifier",
                                                    SERVER_CONFIG)
            ref = tables["per_request"]
            diffs = {m: [k for k in ref if not np.array_equal(ref[k], t[k])]
                     for m, t in tables.items()}
            for m in labels:
                t = tables.get(m, ref)
                if sorted(t) != sorted(ref) or diffs.get(m) \
                        or labels[m] != labels["per_request"]:
                    raise AssertionError(
                        f"operating: the {m} model differs from the "
                        f"per-request one at {diffs[m][:4]}")
            log("operating_modes " + json.dumps({
                "card": card, "clients": OP_CLIENTS, "reqs": OP_REQS,
                "rows": OP_ROWS, "modes": modes_out,
                "sequential_bitwise_equal": True,
                "labels": sum(labels["per_request"].values())}))
            out["modes"] = modes_out

            # (b) tracing overhead: classify qps off / on, in turns
            datums = [[[["w", f"tok{i}"]], [["x", float(rng.random())]], []]
                      for i in range(OP_READ_CLIENTS * OP_READ_REQS)]
            qps = {"off": [], "on": []}
            p50 = {"off": [], "on": []}
            for which in ("pipelined", "traced"):     # first reads apart
                with closing(WireClient(ready[which][0])) as cli:
                    cli.call("classify", datums[:1])
            for which in ("off", "on", "on", "off"):
                port = ready["pipelined" if which == "off" else "traced"][0]
                q, p = op_classify_qps(np, port, datums)
                qps[which].append(round(q, 1))
                p50[which].append(round(p, 3))
            with closing(WireClient(ready["traced"][0])) as cli:
                (spans,) = cli.call("get_traces").values()
                tst = status_of(cli)
            if tst["tracing_enabled"] != "1" or not op_spans(
                    spans, "rpc.classify"):
                raise AssertionError("operating: the traced server kept "
                                     "no rpc.classify span")
            out["tracing"] = {"qps_off": qps["off"], "qps_on": qps["on"],
                              "p50_ms_off": p50["off"],
                              "p50_ms_on": p50["on"],
                              "spans_kept": len(spans)}

            # (e) the exporter against get_metrics at the same moment
            mport = ready["traced"][1]
            with closing(WireClient(ready["traced"][0])) as cli:
                cli.call("get_metrics")         # its own series exist
                code, text = op_scrape(mport, "/metrics")
                (met,) = cli.call("get_metrics").values()
            prom = {}
            for line in text.splitlines():
                name, value = line.rsplit(" ", 1)
                prom[name] = float(value)
            import re as _re
            want = {}
            for k, v in met.items():
                try:
                    want["jubatus_" + _re.sub(r"[^a-zA-Z0-9_:]", "_", k)] = \
                        float(v)
                except ValueError:
                    pass
            frozen = [k for k in want if "kernel_launches" in k
                      or k.startswith("jubatus_rpc_train")]
            if code != 200 or set(prom) != set(want) or any(
                    prom[k] != want[k] for k in frozen):
                raise AssertionError(
                    "operating: /metrics differs from get_metrics: "
                    f"{sorted(set(prom) ^ set(want))[:6]}")
            for path in ("/metrics.json", "/traces.json", "/livez"):
                if op_scrape(mport, path)[0] != 200:
                    raise AssertionError(f"operating: {path} failed")
            out["exporter"] = {"keys": len(prom), "frozen_equal": len(frozen)}

            # (c) a traced --mix_quantize round, mastered by the traced
            # server
            mcli = [WireClient(ready[m][0], "op_mix")
                    for m in ("traced", "pipelined")]
            try:
                for i, c in enumerate(mcli):
                    if c.call("train", bench_batch(rng, REQ_B,
                                                   label_offset=i)) != REQ_B:
                        raise AssertionError("operating: a mix train failed")
                t_mix = time.perf_counter()
                if mcli[0].call("do_mix") is not True:
                    raise AssertionError("operating: do_mix failed")
                mix_wall = (time.perf_counter() - t_mix) * 1e3
                (mspans,) = mcli[0].call("get_traces").values()
                mst = [status_of(c) for c in mcli]
            finally:
                for c in mcli:
                    c.close()
            rounds = [s for s in op_spans(mspans, "mix.round")
                      if "applied" in s["tags"]]
            if len(rounds) != 1 or rounds[0]["tags"]["applied"] != 2:
                raise AssertionError(f"operating: mix.round spans {rounds}")
            legs = {m: [{"peer": s["tags"]["peer"], "ok": s["tags"]["ok"],
                         "round": s["tags"]["round"],
                         "ms": round(s["duration_s"] * 1e3, 3)}
                        for s in op_spans(mspans, f"mix.{m}.leg")]
                    for m in ("get_diff", "put_diff")}
            if [len(v) for v in legs.values()] != [2, 2] or not all(
                    leg["ok"] for v in legs.values() for leg in v):
                raise AssertionError(f"operating: mix legs {legs}")
            q = [launches_of(s) for s in mst]
            for k in ("quantize_int8", "dequantize_int8"):
                if on_card and any(x.get(k, 0) <= 0 for x in q):
                    raise AssertionError(f"operating: {k} not launched in "
                                         "a traced round's server")
            out["mix"] = {
                "round_span_ms": round(rounds[0]["duration_s"] * 1e3, 3),
                "smoke_wall_ms": round(mix_wall, 3),
                "tags": rounds[0]["tags"], "legs": legs,
                **{k: mst[0].get(k) for k in (
                    "mix_bytes_sent_total", "mix_bytes_received_total",
                    "mix_bytes_total", "mix_compression_ratio")},
                "quantize_int8": sum(x.get("quantize_int8", 0) for x in q),
                "dequantize_int8": sum(x.get("dequantize_int8", 0)
                                       for x in q)}

            # (d) a traced read through the proxy at 2 partitions
            pcli = WireClient(pport, "op_part")
            try:
                data = nn_datums(np, rng, OP_PART_ROWS + OP_PART_READS)
                for i in range(OP_PART_ROWS):
                    if pcli.call("set_row", f"p{i}",
                                 nn_wire(data[i])) is not True:
                        raise AssertionError("operating: a set_row failed")
                lat = []
                for d in data[OP_PART_ROWS:]:
                    t1 = time.perf_counter()
                    got = pcli.call("similar_row_from_datum", nn_wire(d),
                                    NN_SIZE)
                    lat.append((time.perf_counter() - t1) * 1e3)
                    if len(got) != NN_SIZE:
                        raise AssertionError("operating: a short read")
                pspans = pcli.call_bare("get_proxy_traces")
                members = pcli.call("get_traces")
                pst = []
                for i in range(2):
                    with closing(WireClient(ready[f"part{i}"][0])) as cli:
                        pst.append(status_of(cli))
            finally:
                pcli.close()
            read = "similar_row_from_datum"

            def ms(spans, name, **tags):
                return [s["duration_s"] * 1e3 for s in spans
                        if s["name"] == name and all(
                            s["tags"].get(k) == v for k, v in tags.items())]
            member_spans = [s for v in members.values() for s in v]
            split = {
                "client_ms": lat,
                "proxy_rpc_ms": ms(pspans, f"rpc.{read}"),
                "forward_ms": ms(pspans, "proxy.forward", method=read),
                "member_rpc_ms": ms(member_spans, f"rpc.{read}"),
                "merge_ms": ms(pspans, "proxy.partition_merge",
                               method=read)}
            if len(split["forward_ms"]) < 2 * OP_PART_READS or len(
                    split["merge_ms"]) != OP_PART_READS or len(
                    split["member_rpc_ms"]) < 2 * OP_PART_READS:
                counts = {k: len(v) for k, v in split.items()}
                raise AssertionError("operating: the proxy's read spans "
                                     f"are missing: {counts}")
            rows = sum(int(s["partition_rows"]) for s in pst)
            if rows != OP_PART_ROWS:
                raise AssertionError(f"operating: partitions hold {rows} "
                                     f"rows, not {OP_PART_ROWS}")
            for s in pst:
                launches.update(launches_of(s))
            out["proxy_split"] = {
                "partitions": 2, "rows": OP_PART_ROWS,
                **{k.replace("_ms", "_p50_ms"): round(pct(np, v, 50), 4)
                   for k, v in split.items()},
                "client_p99_ms": round(pct(np, lat, 99), 4)}

            # (f) --torch_profile: trains with and without the profiler
            batches = [bench_batch(rng, OP_PROFILE_B)
                       for _ in range(OP_PROFILE_TRAINS)]
            twin = WireClient(ready["pipelined"][0])
            pc = WireClient(ready["profile"][0])
            t_prof, t_twin = [], []
            try:
                for b in batches:
                    for cli, acc in ((pc, t_prof), (twin, t_twin)):
                        t1 = time.perf_counter()
                        if cli.call("train", b) != OP_PROFILE_B:
                            raise AssertionError("operating: a profiled "
                                                 "train failed")
                        acc.append((time.perf_counter() - t1) * 1e3)
                for d in datums[:OP_PROFILE_READS]:
                    pc.call("classify", [d])
                prof_launches = launches_of(status_of(pc))
            finally:
                pc.close()
                twin.close()
            prof.p.terminate()     # SIGTERM: the trace is written then
            prof.p.wait(timeout=300)
            if prof.p.returncode != 0:
                raise AssertionError("operating: the profiled server "
                                     f"exited {prof.p.returncode}:\n"
                                     + "".join(prof.tail))
            import glob
            (trace,) = glob.glob(os.path.join(prof_dir, "torch_trace_*"))
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
            if on_card and not any("train_scan" in k for k in kernels):
                raise AssertionError("operating: the profiler's trace names "
                                     f"no train_scan: {sorted(kernels)[:8]}")
            launches.update(prof_launches)
            out["profile"] = {
                "trace_bytes": os.path.getsize(trace),
                "kernel_names": len(kernels),
                "train_ms_profiled": [round(x, 3) for x in t_prof],
                "train_ms_plain": [round(x, 3) for x in t_twin],
                "train_p50_ms_profiled": round(pct(np, t_prof, 50), 3),
                "train_p50_ms_plain": round(pct(np, t_twin, 50), 3)}
            for mode in [*OP_MODES, "traced"]:
                with closing(WireClient(ready[mode][0])) as cli:
                    launches.update(launches_of(status_of(cli)))
            out["startup_s"] = round(startup_s, 3)
        finally:
            for c in reversed(children):
                c.stop()
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    out["card"] = card
    log("operating " + json.dumps(out))
    return dict(launches)


# phase 16: many model slots in one server
TEN_SLOTS = ("m1", "m2", "m3")
TEN_REQS = 16              # train requests of REQ_B datums to each slot
TEN_MAX_SLOTS = 4          # --quota_max_slots of the phase's server
TEN_RPS = 50               # the rate-limited slot's quota.train_rps
TEN_FLOOD = 200            # its requests sent at once, directly and again
TEN_FLOOD_B = 16           # through the proxy; datums a request
TEN_FLOOD_THREADS = 8
TEN_MIX_REQS = 2           # train requests of each slot on each MIX server
TEN_DUR_REQS = 2           # the journaled server's requests of each slot
TEN_DUR_LABELS = 8         # over 8 labels: 8 rows a slot (64 MiB of w and
                           # cov), which its get_model calls carry
TEN_PLUGIN_REQS = 4        # train requests to the plugin slot
TEN_PLUGIN_B = 1024
# the smoke's AROW configuration with a dynamic C splitter: the converter
# builds native/plugins/simple_splitter.c with cc at first use
PLUGIN_CONFIG = dict(SERVER_CONFIG, converter={
    "string_types": {"ws": {
        "method": "dynamic", "function": "create",
        "path": os.path.join(HERE, "jubatus_tpu_torch", "native", "plugins",
                             "simple_splitter.c")}},
    "string_rules": [{"key": "*", "type": "ws", "sample_weight": "tf",
                      "global_weight": "bin"}],
    "num_rules": [{"key": "*", "type": "num"}],
    "hash_max_size": 1 << 20})


_TEN_FEATS = []


def feature_table():
    """The 2^16 string features [w{t%4}, tok{t}], built once and shared by
    every batch (msgpack packs a shared list like any other)."""
    if not _TEN_FEATS:
        _TEN_FEATS.extend([f"w{t % 4}", f"tok{t}"] for t in range(1 << 16))
    return _TEN_FEATS


def ten_batch(rng, n, label_offset=0, labels=N_LABELS):
    """bench_batch's datums (8 string features w{t%4}=tok{t}, t < 2^16,
    and one number) over `labels` labels, drawn in two calls, the
    features shared from one table, for the phase's many requests."""
    get = feature_table().__getitem__
    toks = rng.integers(0, 1 << 16, size=(n, 8)).tolist()
    xs = rng.random(n).tolist()
    names = [f"class{k}" for k in range(labels)]
    return [[names[(i + label_offset) % labels],
             [list(map(get, row)), [["x", x]], []]]
            for i, (row, x) in enumerate(zip(toks, xs))]


def plugin_batch(rng, n, label_offset=0):
    """n wire datums of one text field, 8 words of a 2^16 vocabulary
    joined by spaces, plus one number."""
    return [[f"class{(i + label_offset) % N_LABELS}",
             [[["text", " ".join(f"tok{t}" for t in
                                 rng.integers(0, 1 << 16, size=8))]],
              [["x", float(rng.random())]], []]] for i in range(n)]


def slot_state(torch, slot):
    """A slot's classifier tables, flushed and on the card, by name."""
    if slot.dispatcher is not None:
        slot.dispatcher.flush()
    torch.cuda.synchronize() if slot.driver.device.type == "cuda" else None
    d = slot.driver
    return {"w": d.w, "cov": d.cov, "counts": d.counts, "active": d.active,
            "labels": dict(d.labels)}


def same_state(torch, a, b):
    return a["labels"] == b["labels"] and all(
        torch.equal(a[k], b[k]) for k in ("w", "cov", "counts", "active"))


def ten_frames(rng, name, n, b, make=None, label_offset=0):
    """n train request frames to slot `name` of b datums each (`make`:
    ten_batch), kept as bytes only (a full collection over millions of
    datum objects would cost seconds at every drop), and the first 8
    datums."""
    import msgpack
    frames, first = [], None
    for i in range(n):
        batch = (make or ten_batch)(rng, b, label_offset)
        first = first or [d for _, d in batch[:8]]
        frames.append(msgpack.packb([0, i + 1, "train", [name, batch]],
                                    use_bin_type=True))
    return frames, first


def ten_train(cli, frames, b, query, warm=None):
    """`warm` (a small request: a slot's first window on its dispatch
    thread) and then every frame in turn, each awaiting its ack, then a
    classify that reads scores back (the card's fence): ms a request."""
    if warm is not None:
        cli.call("train", warm)
        cli.call("classify", [warm[0][1]])
    t0 = time.perf_counter()
    for f in frames:
        if cli.send(f, "train") != b:
            raise AssertionError("train acknowledged another datum count")
    cli.call("classify", query[:1])
    return (time.perf_counter() - t0) * 1e3 / len(frames)


def ten_flood(port, name, batch, n, threads):
    """n train requests to `name` from `threads` clients at once ->
    (admitted, refused at the member, refused at the proxy's edge)."""
    import threading
    tally = {"ok": 0, "member": 0, "edge": 0}
    lock = threading.Lock()
    go = threading.Barrier(threads)

    def client(k):
        cli = WireClient(port, name=name)
        frame_list = [cli.frame("train", batch) for _ in range(n // threads)]
        go.wait()
        for f in frame_list:
            try:
                cli.send(f, "train")
                what = "ok"
            except RuntimeError as e:
                if "quota_exceeded" not in str(e):
                    raise
                what = "edge" if "(proxy)" in str(e) else "member"
            with lock:
                tally[what] += 1
        cli.close()

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    if sum(tally.values()) != n:
        raise AssertionError(f"flood: {tally} of {n} requests answered")
    return tally


def phase_tenancy(torch, np, card, device="cuda"):
    """Phase 16: many model slots in one server on the card, the smoke's
    AROW config at 2^20 columns (each slot's w and cov 256 MiB), so every
    slot launches train_scan.  (a) A server with --tenant t0
    --quota_max_slots 4 admits m1-m3 by create_model; each slot trained
    on its own TEN_REQS requests of REQ_B datums routed by argument 0
    ends bitwise equal to a one-slot server fed the same requests, and
    classifies alike; the fifth slot is refused by the cap.  (b) A slot
    with quota.train_rps TEN_RPS gets TEN_FLOOD requests at once,
    directly and then through the port's proxy (whose gate refuses at
    the edge once its view of the slot has landed); the other slots'
    answers are unchanged.  (e) A slot whose converter takes the
    simple_splitter C plugin ("method": "dynamic", built at first use)
    trains and classifies within rtol 1e-5 / atol 1e-6 of a CPU driver
    fed the same datums.  Then every slot is dropped and
    torch.cuda.memory_allocated() must be back at its value before the
    creates.  (c) Two --mix_quantize servers with a coordinator, two
    slots each: one do_mix of slot qa leaves its replicas bitwise equal,
    the other slot bitwise unchanged, launches the quantizer pair, and
    its mix bytes are qa's alone.  (d) A journaled two-slot server
    process, SIGKILLed and restarted: both slots' tables bitwise as
    before the kill, the boot-to-routable ms and the replay's scan
    launches.  -> the phase's kernel launches."""
    import gc

    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.cluster.coordinator import CoordinatorServer
    from jubatus_tpu_torch.framework.proxy import Proxy
    from jubatus_tpu_torch.framework.server_base import kernel_launches
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    out = {"card": card}
    launches = {"train_scan": 0, "quantize_int8": 0, "dequantize_int8": 0}
    parts = {}

    def count(before):
        after = kernel_launches()
        for k in launches:
            launches[k] += after[k] - before[k]
        return {k: after[k] - before[k] for k in launches}

    def allocated():
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def slot_tables(port, name):
        """A slot's tables through the MIX wire's get_model (the model
        field names a secondary slot; j is the default slot)."""
        from jubatus_tpu_torch.mix import codec
        from jubatus_tpu_torch.rpc.client import Client
        with Client("127.0.0.1", port, timeout=600) as c:
            got = c.call_raw("get_model",
                             0 if name == "j" else {"model": name})
        return model_tables(np, codec.decode(got, device)["model"],
                            "classifier")

    def start(*extra):
        return serve(["--type", "classifier", "--configpath", cfg_path,
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--eth", "127.0.0.1", "--datadir", tmp,
                      "--interval_sec", "100000",
                      "--interval_count", "1000000", "--device", device,
                      *extra])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "classifier.json")
        with open(cfg_path, "w") as f:
            json.dump(SERVER_CONFIG, f)
        coord = CoordinatorServer()
        addr = f"127.0.0.1:{coord.start(0, '127.0.0.1')}"
        # (d)'s journaled server process boots while (a)-(c) run; in a
        # cluster, so its slots' tables come out through get_model
        dur_args = ("--name", "j", "--journal", os.path.join(tmp, "wal"),
                    "--snapshot_interval", "0", "--coordinator", addr,
                    "--interval_sec", "100000", "--interval_count",
                    "1000000")
        dur, t_dur = start_server("classifier", cfg_path, tmp, *dur_args,
                                  device=device)
        running = []
        proxy = None
        try:
            # (a) three slots in one server
            t_part = time.perf_counter()
            server, rpc = start("--name", "c", "--coordinator", addr,
                                "--tenant", "t0", "--quota_max_slots",
                                str(TEN_MAX_SLOTS))
            running.append((server, rpc))
            port = server.args.rpc_port
            cli = WireClient(port, name="c")
            mem = {"before_creates": allocated()}
            for name in TEN_SLOTS:
                if cli.call("create_model", {"name": name,
                                             "tenant": "t0"}) is not True:
                    raise AssertionError(f"create_model {name} failed")
            mem["after_creates"] = allocated()
            try:
                cli.call("create_model", {"name": "m4", "tenant": "t0"})
                raise AssertionError("a fifth slot passed the slot cap")
            except RuntimeError as e:
                if "slot limit" not in str(e):
                    raise
            reqs, queries = {}, {}
            for n in TEN_SLOTS:
                reqs[n], queries[n] = ten_frames(rng, n, TEN_REQS, REQ_B)
            warm = ten_batch(rng, 64)
            parts["a.frames"] = time.perf_counter() - t_part
            parts["a.twins"] = 0.0
            slots = {}
            answers = {}
            for name in TEN_SLOTS:
                scli = WireClient(port, name=name)
                before = kernel_launches()
                ms = ten_train(scli, reqs[name], REQ_B, queries[name], warm)
                state = slot_state(torch, server.slot_for(name))
                scans = count(before)["train_scan"]
                answers[name] = scli.call("classify", queries[name])
                scli.close()
                # a one-slot server on the same requests
                t_twin = time.perf_counter()
                one, one_rpc = start("--name", name)
                try:
                    ocli = WireClient(one.args.rpc_port, name=name)
                    before = kernel_launches()
                    one_ms = ten_train(ocli, reqs[name], REQ_B,
                                       queries[name], warm)
                    one_scans = count(before)["train_scan"]
                    same = same_state(torch, state, slot_state(torch, one))
                    alike = ocli.call("classify", queries[name]) == \
                        answers[name]
                    ocli.close()
                finally:
                    one_rpc.stop()
                    one.stop()
                del one, one_rpc, state
                parts["a.twins"] += time.perf_counter() - t_twin
                if not (same and alike):
                    raise AssertionError(
                        f"tenancy: slot {name} differs from a one-slot "
                        f"server (tables equal {same}, answers {alike})")
                if on_card and scans <= 0:
                    raise AssertionError(f"slot {name}: no train_scan")
                slots[name] = {"request_ms": round(ms, 3),
                               "one_slot_request_ms": round(one_ms, 3),
                               "train_scan": scans,
                               "one_slot_train_scan": one_scans}
            out["a"] = {"slots": slots, "bitwise": True}
            parts["a"] = time.perf_counter() - t_part
            log(f"tenancy (a): {json.dumps(slots)}")

            # (b) quotas, at the member and at the proxy's edge
            t_part = time.perf_counter()
            cli.call("create_model", {"name": "lim", "tenant": "t1",
                                      "quota": {"train_rps": TEN_RPS}})
            small = ten_batch(rng, TEN_FLOOD_B)
            before = kernel_launches()
            direct = ten_flood(port, "lim", small, TEN_FLOOD,
                               TEN_FLOOD_THREADS)
            proxy = Proxy(addr, "classifier", membership_ttl=0.0)
            pport = proxy.start(0, host="127.0.0.1")
            deadline = time.monotonic() + 30
            while proxy.quota_gate.info_of("lim") is None:
                if time.monotonic() > deadline:
                    raise AssertionError("the proxy's tenancy view of lim "
                                         "never landed")
                time.sleep(0.05)
            time.sleep(1.0)          # the buckets refill a second's burst
            edge = ten_flood(pport, "lim", small, TEN_FLOOD,
                             TEN_FLOOD_THREADS)
            count(before)
            st = status_of(cli)
            rejected = st.get("tenant_quota_rejected_total.t1")
            for name in TEN_SLOTS:
                scli = WireClient(port, name=name)
                if scli.call("classify", queries[name]) != answers[name]:
                    raise AssertionError(f"slot {name} changed under the "
                                         "flood")
                scli.close()
            if not (direct["member"] > 0 and edge["edge"] > 0
                    and direct["ok"] < TEN_FLOOD):
                raise AssertionError(f"quotas: direct {direct}, through "
                                     f"the proxy {edge}")
            out["b"] = {"direct": direct, "proxy": edge,
                        "tenant_quota_rejected_total.t1": rejected}
            log(f"tenancy (b): {json.dumps(out['b'])}")
            parts["b"] = time.perf_counter() - t_part
            t_part = time.perf_counter()

            # (e) a C plugin on the card
            spec = {"name": "plug", "tenant": "t2",
                    "config": json.dumps(PLUGIN_CONFIG)}
            if cli.call("create_model", spec) is not True:
                raise AssertionError("create_model plug failed")
            prng = np.random.default_rng(20)
            pframes, pquery = ten_frames(prng, "plug", TEN_PLUGIN_REQS,
                                         TEN_PLUGIN_B, plugin_batch)
            pcli = WireClient(port, name="plug")
            before = kernel_launches()
            pms = ten_train(pcli, pframes, TEN_PLUGIN_B, pquery)
            pscans = count(before)["train_scan"]
            got = pcli.call("classify", pquery)
            pcli.close()
            # a driver in this process on the same device, fed the same
            # datums through its own decoded train (the plugin's spans,
            # the Python converter, the scan): the wire slot's answers
            # bitwise; the CPU parity is tests/test_torch_plugin.py's
            # (a copy: the loader keeps its plugin object in the type-def)
            ref = create_driver("classifier",
                                json.loads(json.dumps(PLUGIN_CONFIG)),
                                device=device)
            prng = np.random.default_rng(20)
            for _ in range(TEN_PLUGIN_REQS):
                ref.train([(lbl, Datum.from_msgpack(d)) for lbl, d in
                           plugin_batch(prng, TEN_PLUGIN_B)])
            want = ref.classify([Datum.from_msgpack(d) for d in pquery])
            del ref
            if got != [[[lbl, sc] for lbl, sc in row] for row in want]:
                raise AssertionError("plugin slot: classify differs from "
                                     "an in-process driver's")
            if on_card and pscans <= 0:
                raise AssertionError("plugin slot: no train_scan launch")
            out["e"] = {"request_ms": round(pms, 3), "train_scan": pscans,
                        "bitwise": True}
            log(f"tenancy (e): {json.dumps(out['e'])}")
            parts["e"] = time.perf_counter() - t_part

            # every slot dropped: the card's memory comes back
            for name in TEN_SLOTS + ("lim", "plug"):
                if cli.call("drop_model", name) is not True:
                    raise AssertionError(f"drop_model {name} failed")
            mem["after_drops"] = allocated()
            out["memory_allocated"] = mem
            log(f"tenancy: memory_allocated {json.dumps(mem)}")
            if mem["after_drops"] != mem["before_creates"]:
                raise AssertionError(f"the drops left memory allocated: "
                                     f"{mem}")
            cli.close()
            proxy.stop()
            proxy = None
            rpc.stop()
            server.stop()
            running.clear()
            del server, rpc

            # (c) per-slot MIX on the v3 wire
            t_part = time.perf_counter()
            pair = [start("--name", "q", "--coordinator", addr,
                          "--mix_quantize") for _ in range(2)]
            running += pair
            for s, _ in pair:
                s.create_model({"name": "qa", "tenant": "t3"})
            for (s, _), half in zip(pair, range(2)):
                for name in ("qa", "q"):
                    mcli = WireClient(s.args.rpc_port, name=name)
                    frames, q = ten_frames(rng, name, TEN_MIX_REQS, REQ_B,
                                           label_offset=half)
                    ten_train(mcli, frames, REQ_B, q)
                    mcli.close()
            b_before = [{k: v.clone() if torch.is_tensor(v) else v
                         for k, v in slot_state(torch, s).items()}
                        for s, _ in pair]
            for s, _ in pair:
                slot_state(torch, s.slot_for("qa"))
            before = kernel_launches()
            mcli = WireClient(pair[0][0].args.rpc_port, name="qa")
            t0 = time.perf_counter()
            if mcli.call("do_mix") is not True:
                raise AssertionError("do_mix of qa failed")
            mix_ms = (time.perf_counter() - t0) * 1e3
            mst = status_of(mcli)
            mcli.close()
            quant = count(before)
            # rows are numbered per process: the replicas' tables by label
            qa = [model_tables(np, s.slot_for("qa").driver.pack(),
                               "classifier") for s, _ in pair]
            if not same_tables(np, qa[0], qa[1]):
                raise AssertionError("qa's replicas differ after its round")
            if not all(same_state(torch, b, slot_state(torch, s))
                       for b, (s, _) in zip(b_before, pair)):
                raise AssertionError("qa's round moved slot q")
            if on_card and not (quant["quantize_int8"] > 0
                                and quant["dequantize_int8"] > 0):
                raise AssertionError(f"qa's round: quantizers {quant}")
            out["c"] = {
                "do_mix_ms": round(mix_ms, 3),
                "quantize_int8": quant["quantize_int8"],
                "dequantize_int8": quant["dequantize_int8"],
                "mix_round.qa": mst.get("mix_round.qa"),
                "mix_round.q": mst.get("mix_round"),
                "last_mix_wire_bytes.qa": mst.get("last_mix_wire_bytes.qa"),
                "last_mix_wire_bytes.q": mst.get("last_mix_wire_bytes"),
                "mix_bytes_sent_total": mst.get("mix_bytes_sent_total")}
            log(f"tenancy (c): {json.dumps(out['c'])}")
            if out["c"]["mix_round.qa"] != "1" or \
                    out["c"]["mix_round.q"] != "0":
                raise AssertionError(f"mix rounds: {out['c']}")
            for s, r in pair:
                r.stop()
                s.stop()
            running.clear()
            del pair, b_before, qa
            parts["c"] = time.perf_counter() - t_part

            # (d) recovery of every slot of a journaled server process
            t_part = time.perf_counter()
            dport, _ = server_ready(dur, t_dur)
            parts["d.first_boot_wait"] = time.perf_counter() - t_part
            dcli = WireClient(dport, name="j")
            if dcli.call("create_model", {"name": "j1"}) is not True:
                raise AssertionError("create_model j1 failed")
            before_kill = {}
            for name in ("j", "j1"):
                jcli = WireClient(dport, name=name)
                frames, q = ten_frames(
                    rng, name, TEN_DUR_REQS, REQ_B,
                    lambda r, b, off: ten_batch(r, b, off, TEN_DUR_LABELS))
                ten_train(jcli, frames, REQ_B, q)
                jcli.close()
                t_tab = time.perf_counter()
                before_kill[name] = slot_tables(dport, name)
                parts["d.tables"] = parts.get("d.tables", 0.0) + \
                    time.perf_counter() - t_tab
            dcli.close()
            dur.kill()
            dur, t_dur = start_server("classifier", cfg_path, tmp,
                                      *dur_args, device=device)
            dport, reboot_ms = server_ready(dur, t_dur)
            dcli = WireClient(dport, name="j")
            st = status_of(dcli)
            replay = launches_of(st)
            same = {name: same_tables(np, before_kill[name],
                                      slot_tables(dport, name))
                    for name in ("j", "j1")}
            dcli.close()
            launches["train_scan"] += replay["train_scan"]
            out["d"] = {"bitwise": same, "boot_to_routable_ms": round(
                reboot_ms, 1), "replay_train_scan": replay["train_scan"],
                "recovery_replayed": st.get("recovery_replayed"),
                "recovery_replayed.j1": st.get("recovery_replayed.j1")}
            log(f"tenancy (d): {json.dumps(out['d'])}")
            if not all(same.values()):
                raise AssertionError(f"recovery: tables differ {same}")
            if on_card and replay["train_scan"] < 2 * TEN_DUR_REQS:
                raise AssertionError(f"recovery replayed "
                                     f"{replay['train_scan']} scans")
            parts["d"] = time.perf_counter() - t_part
        finally:
            if proxy is not None:
                proxy.stop()
            for s, r in running:
                r.stop()
                s.stop()
            dur.stop()
            coord.stop()
    out["launches"] = launches
    out["part_s"] = {k: round(v, 1) for k, v in parts.items()}
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log("tenancy " + json.dumps(out))
    return launches


# -- phase 17: the data-parallel tier -----------------------------------------

DP_NDPS = (1, 4, 8)       # replicas of the in-process grid launches
DP_FOLD_NDP = 8           # replicas of the in-process fold
DP_SERVER_NDP = 4         # replicas of the standalone and journaled servers
DP_REQS = 4               # REQ_B-datum requests to each standalone server:
#                           two count-triggered rounds, three warm requests
DP_TOPK = 32768           # --mix_topk of one member of the (c) cluster
DP_CONFIG = dict(SERVER_CONFIG, parameter=dict(
    SERVER_CONFIG["parameter"], mix_payload="int8"))


def dp_grid_row(torch, np, dev, kind):
    """(a) The replica grid at ndp 1, 4 and 8 on one REQ_B-datum
    microbatch (replica r its slice): every replica bitwise ndp one-block
    launches on the slices, integer state bitwise and the tables within
    rtol 1e-5 / atol 1e-6 of the plain per-replica loop at ndp 8 (the
    scan kernel sums in another order than its plain version), and the
    grid's device ms beside the one-block scan of the whole batch (the
    grid at ndp 1: train_scan launches the same C entry at one block).
    Returns the kernel row (ndp 8 its main shape)."""
    from jubatus_tpu_torch.models import classifier as tc
    from jubatus_tpu_torch.models import regression as tr
    L, K = N_LABELS, 16
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)

    def timed(fn, reps):
        return time_cuda(torch, fn, reps) if card else None

    if kind == "classifier":
        fresh, batch = scan_inputs(torch, np, dev, REQ_B, 17)
        D = fresh[0].shape[1]
        grid_fn, one_fn, ref_fn = (tc.train_scan_grid, tc.train_scan,
                                   tc.train_scan_grid_ref)
        args = ("AROW", 1.0)

        def stacked(ndp):
            return [t.unsqueeze(0).expand((ndp,) + tuple(t.shape)).clone()
                    for t in fresh]

        def one(st, r, rows):
            one_fn(*[t[r] for t in st], *[t[rows] for t in batch], *args)
    else:
        w0, batch = reg_scan_inputs(torch, np, dev, REQ_B, 17)
        D = w0.shape[0]
        grid_fn, one_fn, ref_fn = (tr.train_scan_grid, tr.train_scan,
                                   tr.train_scan_grid_ref)
        args = ("PA", 1.0, 0.1)

        def stacked(ndp):
            return [w0.unsqueeze(0).expand(ndp, D).clone()]

        def one(st, r, rows):
            one_fn(st[0][r], *[t[rows] for t in batch], *args)
    if DP_NDPS[0] != 1:
        raise AssertionError("dp: the grid's first ndp is the one-block "
                             "scan it is timed beside")
    variants, err, plain_ms = [], 0.0, None
    for ndp in DP_NDPS:
        per = REQ_B // ndp
        grid = stacked(ndp)
        base = [t.clone() for t in grid]
        ones = [t.clone() for t in grid]
        n0 = grid_fn.launches
        grid_fn(*grid, *batch, *args)
        if card and grid_fn.launches != n0 + 1:
            raise AssertionError(f"{kind} grid: not one launch")
        for r in range(ndp):
            one(ones, r, slice(r * per, (r + 1) * per))
        sync()
        if not all(torch.equal(a, b) for a, b in zip(grid, ones)):
            raise AssertionError(f"{kind} grid ndp {ndp}: not bitwise "
                                 f"{ndp} one-block launches on the slices")
        if ndp == DP_FOLD_NDP:
            # the plain per-replica loop over the whole batch, from the
            # same state: integers bitwise, tables within tolerance
            plain = [t.clone() for t in base]
            sync()
            t0 = time.perf_counter()
            ref_fn(*plain, *batch, *args)
            sync()
            plain_ms = (time.perf_counter() - t0) * 1e3
            floats = [0, 1] if kind == "classifier" else [0]
            for i, (a, b) in enumerate(zip(grid, plain)):
                if i in floats:
                    e = float((a - b).abs().max())
                    err = max(err, e)
                    if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                        raise AssertionError(f"{kind} grid ndp {ndp}: max "
                                             f"|diff| {e} from the plain "
                                             "loop")
                elif not torch.equal(a, b):
                    raise AssertionError(f"{kind} grid ndp {ndp}: integer "
                                         "state differs from the plain loop")
            del plain
        ms = timed(lambda: grid_fn(*grid, *batch, *args), 3)
        if ndp == 1:
            single_ms = ms
        # bytes: the batch once; per replica the w entries of its distinct
        # live columns (all labels for the classifier) read once; every
        # entry the launch wrote (cov read and written); counts, active
        live = batch[3] > 0
        ucols = sum(int(torch.unique(batch[0][r * per:(r + 1) * per][
            live[r * per:(r + 1) * per]]).numel()) for r in range(ndp))
        written = [int((a != b).sum()) for a, b in zip(ones, base)]
        if kind == "classifier":
            nbytes = (REQ_B * (2 * K + 2) * 4 + 4 * L * ucols
                      + 4 * (written[0] + 2 * written[1]) + ndp * 2 * L * 5)
        else:
            nbytes = REQ_B * (2 * K + 2) * 4 + 4 * ucols + 4 * written[0]
        variants.append(dict(
            ndp=ndp, ms=ms, single_block_ms=single_ms,
            speedup=single_ms / ms if card else None,
            us_per_datum=ms * 1e3 / REQ_B if card else None,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            state_bytes=sum(t.numel() * t.element_size() for t in grid)))
        del grid, base, ones
        if card:
            torch.cuda.empty_cache()
    for v in variants:
        log(f"dp: {kind} grid ndp {v['ndp']}: {v['ms']} ms a {REQ_B}-datum "
            f"launch ({v['us_per_datum']} us a datum) beside {single_ms} ms "
            f"for one block over the whole batch ({v['speedup']}x), bound "
            f"{v['bound_ms']:.5f} ms; bitwise {v['ndp']} one-block "
            f"launches; state {v['state_bytes']} bytes")
    main = variants[-1]
    return dict(ms=main["ms"], plain_ms=plain_ms, library_ms=None,
                max_abs_err=err, bound_ms=main["bound_ms"],
                bound_by="bytes",
                shape=([REQ_B, K, L, D, DP_FOLD_NDP] if kind == "classifier"
                       else [REQ_B, K, D, DP_FOLD_NDP]),
                us_per_datum=main["us_per_datum"], variants=variants)


def dp_fold(torch, np, dev):
    """(a) A DP driver at ndp 8 on the card (L 32, D 2^20), its memory
    against the reckoning (w, cov and their device bases: 4 tables of
    ndp * L * D floats), then one fold of its diverged replicas with
    payload f32 and int8: the ring on the card bitwise the same ring on
    the plain quantizer pair on the card, n quantize and 2n - 1 dequantize
    launches a float leaf, the fold's device ms and scratch bytes."""
    import gc
    from unittest import mock

    import msgpack

    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.parallel import quantized as tq
    from jubatus_tpu_torch.parallel.collective import make_tree_mix
    from jubatus_tpu_torch.parallel.dp import DPClassifierDriver
    from jubatus_tpu_torch.parallel.mesh import make_mesh
    n, L = DP_FOLD_NDP, N_LABELS
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)

    def allocated():
        # collect first: garbage of earlier phases (a cycle holding a card
        # tensor) freed by a collection the driver's build triggers would
        # count against what the driver holds
        gc.collect()
        sync()
        return torch.cuda.memory_allocated() if card else 0

    before = allocated()
    drv = DPClassifierDriver(DP_CONFIG, make_mesh(dp=n, device=dev))
    rng = np.random.default_rng(23)
    frame = msgpack.packb([0, 1, "train", ["", bench_batch(rng, REQ_B)]],
                          use_bin_type=True)
    off = native.load().parse_envelope(frame, 0)[4]
    drv.train_converted_batch(drv.convert_raw_batch([(frame, off)]))
    D = drv.dim
    held = allocated() - before
    reckoned = 4 * n * drv.capacity * D * 4
    if drv.capacity != L or (card and held < reckoned):
        raise AssertionError(f"dp fold: capacity {drv.capacity}, "
                             f"{held} bytes held for {reckoned} reckoned")
    state = {"w": drv.w, "cov": drv.cov, "counts": drv.counts,
             "active": drv.active}
    base = {"w": drv.w_dbase, "cov": drv.cov_dbase,
            "counts": drv.counts_dbase, "active": drv.active}
    out = {"held_bytes": held, "reckoned_bytes": reckoned}
    for payload in ("f32", "int8"):
        tree = make_tree_mix(n, payload)
        q0 = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
        base_mem = allocated()
        if card:
            torch.cuda.reset_peak_memory_stats()
        got = tree(state, base)
        sync()
        scratch = torch.cuda.max_memory_allocated() - base_mem if card \
            else None
        launches = (tq.quantize_int8.launches - q0[0],
                    tq.dequantize_int8.launches - q0[1])
        want_launches = (2 * n, 2 * (2 * n - 1)) if payload == "int8" \
            else (0, 0)
        if card and launches != want_launches:
            raise AssertionError(f"dp fold {payload}: launches {launches}, "
                                 f"want {want_launches}")
        if payload == "int8":
            with mock.patch.object(tq, "quantize_int8", tq._quantize_ref), \
                    mock.patch.object(tq, "dequantize_int8",
                                      tq._dequantize_ref):
                plain = tree(state, base)
            sync()
            for k in got:
                if not torch.equal(got[k], plain[k]):
                    raise AssertionError(f"dp fold int8: {k} differs from "
                                         "the ring on the plain quantizer")
        for k in ("w", "cov"):
            if not all(torch.equal(got[k][r], got[k][0]) for r in range(n)):
                raise AssertionError(f"dp fold {payload}: replicas of {k} "
                                     "differ after the fold")
        del got
        ms = time_cuda(torch, lambda: tree(state, base), 2) if card \
            else None
        out[payload] = dict(ms=ms, scratch_bytes=scratch,
                            quantize_launches=launches[0],
                            dequantize_launches=launches[1])
    drv.device_mix()          # the driver's own path, int8
    sync()
    log(f"dp: fold at ndp {n}, L {L}, D {D}: {held} bytes held "
        f"({reckoned} reckoned for w, cov and their bases); f32 "
        f"{out['f32']['ms']} ms, scratch {out['f32']['scratch_bytes']} "
        f"bytes; int8 {out['int8']['ms']} ms, scratch "
        f"{out['int8']['scratch_bytes']} bytes, quantize "
        f"{out['int8']['quantize_launches']} and dequantize "
        f"{out['int8']['dequantize_launches']} launches a round, bitwise "
        f"the ring on the plain quantizer pair")
    del drv, state, base
    if card:
        torch.cuda.empty_cache()
    return out


def dp_twin(torch, service, cfg, frames, mix_after, device):
    """An in-process DP driver on the card fed `frames` through its raw
    entry, a device_mix after the frames at `mix_after`; its pack."""
    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.parallel.dp import create_dp_driver
    from jubatus_tpu_torch.parallel.mesh import make_mesh
    drv = create_dp_driver(service, cfg,
                           make_mesh(dp=DP_SERVER_NDP, device=device))
    splitter = native.load()
    for i, fr in enumerate(frames):
        drv.train_converted_batch(drv.convert_raw_batch(
            [(fr, splitter.parse_envelope(fr, 0)[4])]))
        if i in mix_after:
            drv.device_mix()
    pack = drv.pack()
    del drv
    return pack


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def wait_status(cli, key, want, what, timeout=60):
    deadline = time.monotonic() + timeout
    while True:
        st = status_of(cli)
        if st.get(key) == want:
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: {key} {st.get(key)!r}, want "
                                 f"{want!r}")
        time.sleep(0.1)


def phase_dp_service(torch, np, card, device="cuda", meanwhile=None):
    """(b) A standalone --dp_replicas 4 classifier server (its config's
    mix_payload int8: the ring on quantize.cu) and regression server,
    each with --interval_count 2: DP_REQS wire requests of REQ_B datums,
    a count-triggered collective round after every second; get_status
    reports dp_replicas, mix_collective, collective_round and the
    collective bytes; each server's saved model bitwise an in-process DP
    driver on the card fed the same frames.  (c) Two --mix_quantize
    --dp_replicas 2 classifier servers under the linear mixer (the
    hierarchical round: each get_diff folds its replicas), one at
    --mix_topk DP_TOPK: do_mix until both models agree, with the rounds,
    the wire bytes and each process's quantizer launches.  (d) A journaled
    --dp_replicas 4 classifier server: a request, a do_mix (one cmix
    record), one more request, its saved model, SIGKILL, restart on the
    directory: it replays the cmix record, resumes collective_round and
    saves the same model bitwise.  All servers start at once, and
    `meanwhile()` (the in-process part) runs while they boot.  Returns
    the server processes' kernel launches, summed."""
    from collections import Counter

    from jubatus_tpu_torch.cluster.membership import MembershipClient
    from jubatus_tpu_torch.mix import codec
    from jubatus_tpu_torch.rpc.client import Client
    t_phase = time.perf_counter()
    rng = np.random.default_rng(29)
    children = []
    launches = Counter()
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        cfgs = {"classifier": DP_CONFIG, "regression": REG_CONFIG,
                "plain": SERVER_CONFIG}
        paths = {}
        for k, c in cfgs.items():
            paths[k] = os.path.join(tmp, f"{k}.json")
            with open(paths[k], "w") as f:
                json.dump(c, f)
        try:
            coord = Child(["jubatus_tpu_torch.cluster.coordinator",
                           "--rpc-port", "0", "--listen_addr", "127.0.0.1"])
            children.append(coord)
            ndp = str(DP_SERVER_NDP)
            alone = {svc: start_server(svc, paths[svc], tmp, "--dp_replicas",
                                       ndp, "--interval_count", "2",
                                       "--interval_sec", "100000",
                                       device=device)[0]
                     for svc in ("classifier", "regression")}
            dur_argv = ["--dp_replicas", ndp, "--journal",
                        os.path.join(tmp, "dur"), "--journal_fsync", "batch",
                        "--snapshot_interval", "0", "--interval_count",
                        "1000000", "--interval_sec", "100000"]
            durable = start_server("classifier", paths["classifier"], tmp,
                                   *dur_argv, device=device)[0]
            children += list(alone.values()) + [durable]
            addr = coord.wait_line("jubacoordinator", 120).split()[-1]
            members = [start_server(
                "classifier", paths["plain"], tmp, "--name", "dp_hier",
                "--coordinator", addr, "--mix_quantize", "--dp_replicas",
                "2", "--interval_sec", "100000", "--interval_count",
                "1000000", *(["--mix_topk", str(DP_TOPK)] if i else []),
                device=device)[0] for i in range(2)]
            children += members
            if meanwhile is not None:
                meanwhile()
            ports = {svc: server_ready(c, time.perf_counter())[0]
                     for svc, c in alone.items()}
            # (b) the standalone servers: a round after every 2 requests
            for svc, port in ports.items():
                cli = WireClient(port)
                make = bench_batch if svc == "classifier" else reg_batch
                frames = [cli.frame("train", make(rng, REQ_B))
                          for _ in range(DP_REQS)]
                req_ms = []
                for i, fr in enumerate(frames):
                    t0 = time.perf_counter()
                    if cli.send(fr, "train") != REQ_B:
                        raise AssertionError(f"dp {svc}: a train request "
                                             "was not acknowledged")
                    req_ms.append((time.perf_counter() - t0) * 1e3)
                    if i % 2 == 1:
                        st = wait_status(cli, "collective_round",
                                         str((i + 1) // 2),
                                         f"dp {svc} count-triggered round")
                if DP_REQS % 2:
                    st = status_of(cli)
                if (st["dp_replicas"], st["mix_collective"], st["mixer"]) \
                        != (ndp, "1", "collective_mixer"):
                    raise AssertionError(f"dp {svc}: get_status {st}")
                sent = int(st.get("mix_bytes_sent_total", 0))
                if sent <= 0:
                    raise AssertionError(f"dp {svc}: no collective bytes")
                served = saved_tables(np, cli, svc, cfgs[svc])
                cli.close()
                twin = model_tables(np, dp_twin(
                    torch, svc, cfgs[svc], frames,
                    set(range(1, DP_REQS, 2)), device), svc)
                if not same_tables(np, served, twin):
                    raise AssertionError(f"dp {svc}: the server's model is "
                                         "not bitwise the in-process DP "
                                         "driver's")
                launches.update(launches_of(st))
                report[svc] = dict(request_ms=req_ms,
                                   collective_round=st["collective_round"],
                                   last_collective_sec=float(
                                       st["last_collective_sec"]),
                                   mix_bytes_sent_total=sent,
                                   launches=nonzero(launches_of(st)))
            for c in alone.values():
                c.stop()
            # (c) the hierarchical cluster
            mports = [server_ready(c, time.perf_counter())[0]
                      for c in members]
            membership = MembershipClient(addr, "classifier", "dp_hier")
            deadline = time.monotonic() + 60
            while set(membership.get_all_nodes()) != \
                    {("127.0.0.1", p) for p in mports}:
                if time.monotonic() > deadline:
                    raise AssertionError("dp cluster: members never listed")
                time.sleep(0.1)
            membership.close()
            mclis = [WireClient(p) for p in mports]
            for i, c in enumerate(mclis):
                if c.send(c.frame("train", bench_batch(
                        rng, REQ_B, label_offset=i)), "train") != REQ_B:
                    raise AssertionError("dp cluster: a train request was "
                                         "not acknowledged")

            def model_of(port):
                with Client("127.0.0.1", port, timeout=600) as c:
                    return model_tables(np, codec.decode(
                        c.call_raw("get_model", 0))["model"], "classifier")

            rounds, round_ms = 0, []
            while True:
                rounds += 1
                t0 = time.perf_counter()
                if mclis[0].call("do_mix") is not True:
                    raise AssertionError("dp cluster: do_mix failed")
                round_ms.append((time.perf_counter() - t0) * 1e3)
                models = [model_of(p) for p in mports]
                if same_tables(np, models[0], models[1]):
                    break
                if rounds == 4:
                    raise AssertionError("dp cluster: the members still "
                                         "differ after 4 rounds")
            mst = [status_of(c) for c in mclis]
            for c in mclis:
                c.close()
            for st in mst:
                launches.update(launches_of(st))
            report["cluster"] = dict(
                rounds=rounds, round_ms=round_ms,
                wire_bytes=int(mst[0]["last_mix_wire_bytes"]),
                mix_topk=[st["mix_topk"] for st in mst],
                launches=[nonzero(launches_of(st)) for st in mst])
            for c in members:
                c.stop()
            # (d) the journaled server: a cmix record replayed
            dport = server_ready(durable, time.perf_counter())[0]
            cli = WireClient(dport)
            for i in range(2):
                if cli.send(cli.frame("train", bench_batch(rng, REQ_B)),
                            "train") != REQ_B:
                    raise AssertionError("dp durable: a train request was "
                                         "not acknowledged")
                if i == 0 and cli.call("do_mix") is not True:
                    raise AssertionError("dp durable: do_mix failed")
            before = saved_tables(np, cli, "classifier", DP_CONFIG)
            launches.update(launches_of(status_of(cli)))
            cli.close()
            durable.kill()
            t0 = time.perf_counter()
            durable = start_server("classifier", paths["classifier"], tmp,
                                   *dur_argv, device=device)[0]
            children.append(durable)
            dport, boot_ms = server_ready(durable, t0)
            cli = WireClient(dport)
            st = status_of(cli)
            if (st["recovery_collective_round"], st["collective_round"],
                    st["recovery_replayed"], st["recovery_errors"]) != \
                    ("1", "1", "3", "0"):
                raise AssertionError(f"dp durable: recovery {st}")
            after = saved_tables(np, cli, "classifier", DP_CONFIG)
            cli.close()
            if not same_tables(np, before, after):
                raise AssertionError("dp durable: the recovered model is not "
                                     "bitwise the model before the kill")
            launches.update(launches_of(st))
            report["durable"] = dict(boot_ms=boot_ms,
                                     replayed=int(st["recovery_replayed"]),
                                     launches=nonzero(launches_of(st)))
        finally:
            for c in children:
                c.stop()
    report["phase_s"] = time.perf_counter() - t_phase
    log("dp_service " + json.dumps(report))
    return dict(launches)


def phase_dp(torch, np, card, device="cuda"):
    """Phase 17: the data-parallel tier.  (a) in process: the replica
    grids of both scans at ndp 1, 4, 8 and the fold at ndp 8, while the
    servers of (b)-(d) boot; then the served tier (phase_dp_service).
    Returns (kernel rows, the main path's launches)."""
    dev = torch.device(device)
    rows = {}

    def in_process():
        t0 = time.perf_counter()
        rows["train_scan_grid"] = dp_grid_row(torch, np, dev, "classifier")
        rows["regression_train_scan_grid"] = dp_grid_row(torch, np, dev,
                                                         "regression")
        rows["train_scan_grid"]["fold"] = dp_fold(torch, np, dev)
        log(f"dp: in-process part in {time.perf_counter() - t0:.1f} s")

    counts = phase_dp_service(torch, np, card, device=device,
                              meanwhile=in_process)
    return rows, counts


# ---------------------------------------------------------------------------
# 18. key sharding (--shard_devices): the sharded nearest_neighbor over
#     phase 12a's table, a sharded recommender and anomaly beside their
#     unsharded twins, a journaled --shard_devices server
# ---------------------------------------------------------------------------

SHARD_N = 4                # shards of every sharded driver and server
SHARD_READS = 64           # full reads and indexed reads, half by datum
SHARD_RECO_ROWS = 65_536   # the recommender twin's update_rows
SHARD_ANOM_ADDS = 1_024    # adds to the sharded anomaly and its twin
SHARD_ANOM_READS = 64
SHARD_ANOM_RTOL = 1e-4     # tests/test_sharded_rows.py:144-145's
SHARD_WIRE_ROWS = 2_048    # NN_CLUSTER_ROWS' floor
SHARD_WIRE_READS = 64


def shard_plain(torch, sdrv, q_sigs, qnorms, k, indexed):
    """A sharded read's answer through the plain versions on the same card
    tensors: sig_probe_ref a shard (with the index), else sig_topk_ref a
    shard, then the driver's merge (similarities)."""
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.parallel import sharded as SH
    S, cap = sdrv.nshard, sdrv.capacity
    h, m = sdrv.hash_num, sdrv.method
    if indexed:
        idx = sdrv.index
        csr = idx.device_csr(squeeze=False)
        kb = SH._k_bucket(k * (len(idx.plan) + 1),
                          len(idx.plan) * csr[4] + int(csr[3].shape[1]))
        out = torch.cat([C.sig_probe_ref(
            m, sdrv.sig[s], sdrv.norms[s], cap, sdrv.valid[s], q_sigs,
            qnorms, csr[0][s], csr[1][s], csr[2][s], csr[3][s], csr[4],
            idx.plan, idx.bits, h, kb) for s in range(S)])
        rows, vals, _ = C.probe_result(out, kb)
        cand = SH.merge_candidates(vals, rows, sdrv.shard_row_ids, k,
                                   dedupe=True)
        if len(cand) >= k:
            return cand
    kb = SH._k_bucket(k, cap)
    keys = torch.cat([L.sig_topk_ref(m, sdrv.sig[s], sdrv.norms[s], cap,
                                     q_sigs, qnorms, h, kb, sdrv.valid[s])
                      for s in range(S)])
    rows, vals = L.keys_to_host(keys)
    return SH.merge_candidates(vals, rows, sdrv.shard_row_ids, k)


def shard_nn(torch, np, nn_drv, device="cuda"):
    """Phase 18a: phase 12a's 10^6-row lsh H 64 table (nn_drv, its
    lsh_probe index built) into a ShardedNearestNeighborDriver at SHARD_N
    shards through pack() -> unpack() (seconds printed), lsh_probe built by
    its first read.  SHARD_READS full reads (the index set aside) and
    SHARD_READS indexed reads, half by stored id and half by datum (the
    prototypes, jittered): a full read SHARD_N K3 launches, an indexed one
    SHARD_N K6 launches (and SHARD_N K3 for a fall back), from the
    counters; every answer bitwise the plain per-shard path's on the same
    card tensors, and against the unsharded driver's full sweep equal
    scores position by position with tie-aware ids (full reads) and the
    tie-aware recall@10 (indexed).  Then SHARD_N K3 launches of a read
    timed against one K3 over the whole stack, and SHARD_N K6 launches
    against the unsharded driver's one.  -> (launches, its line)."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.ops import candidates as C
    from jubatus_tpu_torch.ops import lsh as L
    from jubatus_tpu_torch.parallel import sharded as SH
    from jubatus_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(181)
    t0 = time.perf_counter()
    pack = nn_drv.pack()
    pack_s = time.perf_counter() - t0
    sdrv = SH.ShardedNearestNeighborDriver(
        NN_CONFIG, make_mesh(shard=SHARD_N, device=device))
    t0 = time.perf_counter()
    sdrv.unpack(pack)
    if device == "cuda":
        torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0
    del pack
    n = len(sdrv.ids)
    if n != len(nn_drv.ids):
        raise AssertionError(f"shard nn: {n} rows after unpack of "
                             f"{len(nn_drv.ids)}")
    if not sdrv.configure_index("lsh_probe", probes=INDEX_PROBES):
        raise AssertionError("shard nn: lsh_probe declined")
    t0 = time.perf_counter()
    idx = sdrv._index_for_query()          # the lazy rebuild, slab a shard
    sdrv.index.device_csr(squeeze=False)
    build_s = time.perf_counter() - t0
    if idx is None:
        raise AssertionError("shard nn: the index did not engage")
    half = SHARD_READS // 2
    q_ids = [f"r{i}" for i in rng.integers(0, n, half)]
    protos = nn_drv.protos
    q_dat = []
    for p in rng.integers(0, len(protos), half):
        names, vals = protos[p]
        q_dat.append(nn_datum(Datum, (names, (np.asarray(vals) + 0.05 * rng
                                              .standard_normal(NN_NNZ))
                                      .tolist())))

    def run(drv):
        return ([drv.similar_row_from_id(i, NN_SIZE) for i in q_ids]
                + [drv.similar_row_from_datum(d, NN_SIZE) for d in q_dat])

    answers, deltas, read_ms = {}, {}, {}
    fb0 = float(metrics_snapshot().get("index_fallback_total", "0"))
    for mode in ("indexed", "full"):
        saved = sdrv.index
        if mode == "full":
            sdrv.index = None
        try:
            before = launch_counts()
            t0 = time.perf_counter()
            answers[mode] = run(sdrv)
            if device == "cuda":
                torch.cuda.synchronize()
            read_ms[mode] = (time.perf_counter() - t0) * 1e3 / SHARD_READS
            deltas[mode] = launch_delta(before, launch_counts())
        finally:
            sdrv.index = saved
        if mode == "indexed":
            fallbacks = float(metrics_snapshot().get(
                "index_fallback_total", "0")) - fb0
    if device == "cuda":
        check_reads("shard nn (full reads)", deltas["full"],
                    SHARD_N * SHARD_READS, "sig_topk")
        check_reads("shard nn (indexed reads)", deltas["indexed"],
                    SHARD_N * SHARD_READS, "sig_probe")
        check_reads("shard nn (fall backs)", deltas["indexed"],
                    SHARD_N * int(fallbacks), "sig_topk")
        for mode in deltas:
            check_reads(f"shard nn ({mode}: K1 of the datum reads)",
                        deltas[mode], half, "lsh_signature")
    # each answer against the plain per-shard path on the same card
    # tensors (the datum reads' signatures signed again, as they sign)
    queries = [(sdrv.sig[sdrv.ids[i][0], sdrv.ids[i][1]:sdrv.ids[i][1] + 1],
                sdrv.norms[sdrv.ids[i][0],
                           sdrv.ids[i][1]:sdrv.ids[i][1] + 1])
               for i in q_ids] + [sdrv._datum_query(d) for d in q_dat]
    for mode in answers:
        for (qs, qn), ans in zip(queries, answers[mode]):
            if shard_plain(torch, sdrv, qs, qn, min(NN_SIZE, n),
                           mode == "indexed") != ans:
                raise AssertionError(f"shard nn ({mode}): a read differs "
                                     "from the plain per-shard path")
    # against the unsharded driver's full sweep
    saved, nn_drv.index = nn_drv.index, None
    try:
        whole = run(nn_drv)
    finally:
        nn_drv.index = saved
    for a, b in zip(answers["full"], whole):
        if not tie_eq(a, b):
            raise AssertionError("shard nn: a full read differs from the "
                                 "unsharded driver's beyond its ties")
    recall = recall_of(answers["indexed"], whole)
    # S launches of a read against one launch over the same stack / the
    # unsharded table
    q0, n0 = queries[half]
    S, cap = SHARD_N, sdrv.capacity
    kb3 = SH._k_bucket(min(NN_SIZE, n), cap)
    csr = sdrv.index.device_csr(squeeze=False)
    kb6 = SH._k_bucket(min(NN_SIZE, n) * (len(idx.plan) + 1),
                       len(idx.plan) * csr[4] + int(csr[3].shape[1]))
    flat_sig = sdrv.sig.view(S * cap, -1)
    times = {
        "k3_shards_ms": nn_times(torch, lambda: [L.sig_topk(
            "lsh", sdrv.sig[s], sdrv.norms[s], cap, q_sigs=q0, qnorms=n0,
            hash_num=64, kb=kb3, mask=sdrv.valid[s]) for s in range(S)],
            device, 20)[0],
        "k3_one_over_stack_ms": nn_times(torch, lambda: L.sig_topk(
            "lsh", flat_sig, sdrv.norms.view(-1), S * cap, q_sigs=q0,
            qnorms=n0, hash_num=64, kb=kb3, mask=sdrv.valid.view(-1)),
            device, 20)[0],
        "k6_shards_ms": nn_times(torch, lambda: [C.sig_probe(
            "lsh", sdrv.sig[s], sdrv.norms[s], cap, sdrv.valid[s],
            (csr[0][s], csr[1][s], csr[2][s], csr[3][s], csr[4]), idx.plan,
            idx.bits, 64, kb6, q_sigs=q0, qnorms=n0) for s in range(S)],
            device, 20)[0]}
    uidx = nn_drv.index
    ucsr = uidx.device_csr()
    times["k6_unsharded_ms"] = nn_times(torch, lambda: C.sig_probe(
        "lsh", nn_drv.sig, nn_drv.norms, len(nn_drv.ids), None, ucsr,
        uidx.plan, uidx.bits, 64, C._kb(NN_SIZE, uidx.plan, ucsr[4],
                                        ucsr[3]),
        q_sigs=q0, qnorms=n0), device, 20)[0]
    line = {"rows": n, "shards": S, "capacity": cap, "pack_s": pack_s,
            "unpack_s": unpack_s, "index_build_s": build_s,
            "rows_per_shard": sdrv.get_status()["rows_per_shard"],
            "read_ms": read_ms, "fallbacks": fallbacks, "recall": recall,
            "kb": {"k3": kb3, "k6": kb6}, **times}
    log(f"shard: nn: {n} rows into {S} shards by pack/unpack in "
        f"{pack_s:.1f} + {unpack_s:.1f} s, lsh_probe built in "
        f"{build_s:.1f} s; {SHARD_READS} full reads ({read_ms['full']:.3f} "
        f"ms a read) and {SHARD_READS} indexed ({read_ms['indexed']:.3f} ms, "
        f"{fallbacks:.0f} fall backs, recall@10 {recall:.4f}), {S} launches "
        "a read, bitwise the plain per-shard path; full reads equal the "
        "unsharded driver's up to ties")
    counts = {}
    for d in deltas.values():
        for k, v in d.items():
            counts[k] = counts.get(k, 0) + v
    return counts, line


def shard_rows(np, rng, n):
    """n datums of NN_NNZ distinct features of 2^16 names (an odd stride
    from a random start), standard normal values."""
    keys = 1 << 16
    start = rng.integers(0, keys, n)[:, None]
    stride = (2 * rng.integers(0, keys // 2, n) + 1)[:, None]
    ks = (start + stride * np.arange(NN_NNZ)[None, :]) % keys
    vals = rng.standard_normal((n, NN_NNZ))
    return [([f"f{k}" for k in row], v)
            for row, v in zip(ks.tolist(), vals.tolist())]


def shard_row_engines(torch, np, device="cuda"):
    """Phase 18b: a sharded recommender (RECO_CONFIG, lsh H 128) at
    SHARD_N shards loaded from its unsharded twin's SHARD_RECO_ROWS rows
    (update_row, then pack -> unpack), SHARD_READS reads each: scores
    equal position by position, ids tie-aware, a read one K1 and one
    masked K3 launch over the placed flat table; a sharded anomaly
    (LOF_CONFIG) and its twin fed SHARD_ANOM_ADDS adds and
    SHARD_ANOM_READS calc_score reads, within SHARD_ANOM_RTOL, an add or a
    read one K5 launch.  -> (launches, its line)."""
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models import create_driver
    from jubatus_tpu_torch.parallel.mesh import make_mesh
    from jubatus_tpu_torch.parallel.sharded_rows import (
        ShardedAnomalyDriver, ShardedRecommenderDriver)
    rng = np.random.default_rng(182)
    mesh = make_mesh(shard=SHARD_N, device=device)
    out, counts = {}, {}

    def add(d):
        for k, v in d.items():
            counts[k] = counts.get(k, 0) + v

    twin = create_driver("recommender", RECO_CONFIG, device=device)
    data = shard_rows(np, rng, SHARD_RECO_ROWS + SHARD_READS)
    t0 = time.perf_counter()
    for i, d in enumerate(data[:SHARD_RECO_ROWS]):
        twin.update_row(f"u{i}", nn_datum(Datum, d))
    fill_s = time.perf_counter() - t0
    reco = ShardedRecommenderDriver(RECO_CONFIG, mesh)
    t0 = time.perf_counter()
    reco.unpack(twin.pack())
    load_s = time.perf_counter() - t0
    queries = [nn_datum(Datum, d) for d in data[SHARD_RECO_ROWS:]]
    want = [twin.similar_row_from_datum(q, NN_SIZE) for q in queries]
    reco.similar_row_from_datum(queries[0], NN_SIZE)   # the first sync
    before = launch_counts()
    t0 = time.perf_counter()
    got = [reco.similar_row_from_datum(q, NN_SIZE) for q in queries]
    reco_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads("shard reco", delta, len(queries), "sig_topk")
        check_reads("shard reco (K1)", delta, len(queries), "lsh_signature")
    add(delta)
    for a, b in zip(got, want):
        if not tie_eq(a, b):
            raise AssertionError("shard reco: a read differs from the "
                                 "unsharded twin's beyond its ties")
    st = reco.get_status()
    out["reco"] = {"rows": SHARD_RECO_ROWS, "twin_fill_s": fill_s,
                   "load_s": load_s, "read_ms": reco_ms,
                   "shard_capacity": int(st["shard_capacity"])}
    del twin, reco
    anom = ShardedAnomalyDriver(LOF_CONFIG, mesh)
    atwin = create_driver("anomaly", LOF_CONFIG, device=device)
    data = shard_rows(np, rng, SHARD_ANOM_ADDS + SHARD_ANOM_READS)
    worst = 0.0
    before = launch_counts()
    t0 = time.perf_counter()
    for i, d in enumerate(data[:SHARD_ANOM_ADDS]):
        a = anom.add(f"a{i}", nn_datum(Datum, d))
        b = atwin.add(f"a{i}", nn_datum(Datum, d))
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    add_s = time.perf_counter() - t0
    for d in data[SHARD_ANOM_ADDS:]:
        a = anom.calc_score(nn_datum(Datum, d))
        b = atwin.calc_score(nn_datum(Datum, d))
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    delta = launch_delta(before, launch_counts())
    if device == "cuda":
        check_reads("shard anomaly", delta,
                    2 * (SHARD_ANOM_ADDS + SHARD_ANOM_READS), "sig_counts")
    if worst > SHARD_ANOM_RTOL:
        raise AssertionError(f"shard anomaly: a score {worst:.3g} off its "
                             f"twin's (rtol {SHARD_ANOM_RTOL})")
    add(delta)
    out["anomaly"] = {"adds": SHARD_ANOM_ADDS, "reads": SHARD_ANOM_READS,
                      "both_drivers_s": add_s, "max_rel_diff": worst,
                      "shard_capacity": anom.shard_cap}
    log(f"shard: reco: {SHARD_RECO_ROWS} rows loaded into {SHARD_N} shards "
        f"in {load_s:.1f} s, {len(queries)} reads {reco_ms:.3f} ms a read, "
        f"equal to the twin's up to ties; anomaly: {SHARD_ANOM_ADDS} adds "
        f"and {SHARD_ANOM_READS} reads beside the twin in {add_s:.1f} s, "
        f"scores within {worst:.3g}")
    return counts, out


def shard_wire(torch, np, child, cfg_path, tmp, argv, device="cuda"):
    """Phase 18c: the --shard_devices SHARD_N --journal nearest_neighbor
    server `child` (booted during 18a-b): SHARD_WIRE_ROWS wire set_rows,
    SHARD_WIRE_READS reads (datum and id), its status keys (shards,
    rows_per_shard, SHARD_N K3 launches a read), a save; SIGKILL, then the
    restart on its journal beside a plain server booting the saved model
    (--model_file): the restart's reads bitwise, the plain server's equal
    up to ties; boot to routable printed.  -> (launches, its line)."""
    rng = np.random.default_rng(183)
    port, boot_ms = server_ready(*child)
    data = nn_datums(np, rng, SHARD_WIRE_ROWS + SHARD_WIRE_READS)
    cli = WireClient(port)
    t0 = time.perf_counter()
    for i, d in enumerate(data[:SHARD_WIRE_ROWS]):
        if cli.call("set_row", f"w{i}", nn_wire(d)) is not True:
            raise AssertionError("shard wire: a set_row was not "
                                 "acknowledged")
    write_s = time.perf_counter() - t0
    half = SHARD_WIRE_READS // 2
    reads = ([("similar_row_from_datum", nn_wire(d))
              for d in data[SHARD_WIRE_ROWS:SHARD_WIRE_ROWS + half]]
             + [("similar_row_from_id", f"w{i}")
                for i in rng.integers(0, SHARD_WIRE_ROWS, half)])

    def ask(c):
        return [c.call(m, a, NN_SIZE) for m, a in reads]

    s0 = status_of(cli)
    answers = ask(cli)
    st = status_of(cli)
    if (st["shards"], st["num_rows"]) != (str(SHARD_N),
                                          str(SHARD_WIRE_ROWS)) or \
            sum(int(x) for x in st["rows_per_shard"].split(",")) \
            != SHARD_WIRE_ROWS:
        raise AssertionError(f"shard wire: status shards {st['shards']}, "
                             f"rows {st['num_rows']}, per shard "
                             f"{st['rows_per_shard']}")
    sdelta = launch_delta(launches_of(s0), launches_of(st))
    if device == "cuda":
        check_reads("shard wire", sdelta, SHARD_N * len(reads), "sig_topk")
    saved = next(iter(cli.call("save", "shard18").values()))
    cli.close()
    child[0].kill()
    restart = start_server("nearest_neighbor", cfg_path, tmp, *argv,
                           device=device)
    plain = start_server("nearest_neighbor", cfg_path, tmp, "--model_file",
                         saved, device=device)
    children = [restart[0], plain[0]]
    try:
        rport, reboot_ms = server_ready(*restart)
        pport, _ = server_ready(*plain)
        rcli, pcli = WireClient(rport), WireClient(pport)
        rst = status_of(rcli)
        again = ask(rcli)
        loaded = ask(pcli)
        pst = status_of(pcli)
        rst2 = status_of(rcli)
        rcli.close()
        pcli.close()
    finally:
        for ch in children:
            ch.stop()
    if again != answers:
        raise AssertionError("shard wire: the restarted server's reads "
                             "differ from before the kill")
    for a, b in zip(loaded, answers):
        if not tie_eq(a, b):
            raise AssertionError("shard wire: the plain server that loaded "
                                 "the sharded model answers otherwise")
    if rst["recovery_errors"] != "0" or \
            int(rst["recovery_replayed"]) < SHARD_WIRE_ROWS or \
            rst["shards"] != str(SHARD_N) or "shards" in pst:
        raise AssertionError(f"shard wire: the restart replayed "
                             f"{rst['recovery_replayed']} records with "
                             f"{rst['recovery_errors']} errors")
    counts = {}
    for d in (launches_of(st), launches_of(rst2), launches_of(pst)):
        for k, v in d.items():
            counts[k] = counts.get(k, 0) + v
    line = {"boot_ms": boot_ms, "write_s": write_s,
            "rows": SHARD_WIRE_ROWS, "reads": len(reads),
            "rows_per_shard": st["rows_per_shard"],
            "restart": {"boot_to_routable_ms": reboot_ms,
                        "recovery_replayed": int(rst["recovery_replayed"]),
                        "recovery_replay_ms": float(
                            rst["recovery_replay_ms"])},
            "read_launches": {"sig_topk": sdelta.get("sig_topk", 0)}}
    log(f"shard: wire: {SHARD_WIRE_ROWS} set_rows in {write_s:.1f} s and "
        f"{len(reads)} reads on a --shard_devices {SHARD_N} server "
        f"({SHARD_N} K3 launches a read); SIGKILL, back in "
        f"{reboot_ms:.0f} ms replaying {rst['recovery_replayed']} records, "
        "bitwise; a plain server on its saved model answers alike")
    return counts, line


def phase_shard(torch, np, card, nn_drv, device="cuda"):
    """Phase 18: key sharding.  The journaled --shard_devices server of
    18c boots while 18a and 18b run in process.  -> (launches, line)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path = os.path.join(tmp, "nn_shard.json")
        with open(cfg_path, "w") as f:
            json.dump(NN_CONFIG, f)
        argv = ("--shard_devices", str(SHARD_N), "--journal",
                os.path.join(tmp, "dur"), "--journal_fsync", "batch",
                "--snapshot_interval", "0")
        child = start_server("nearest_neighbor", cfg_path, tmp, *argv,
                             device=device)
        try:
            t0 = time.perf_counter()
            nn_counts, nn_line = shard_nn(torch, np, nn_drv, device=device)
            t_a = time.perf_counter() - t0
            row_counts, row_line = shard_row_engines(torch, np,
                                                     device=device)
            t_b = time.perf_counter() - t0 - t_a
            wire_counts, wire_line = shard_wire(torch, np, child, cfg_path,
                                                tmp, argv, device=device)
            t_c = time.perf_counter() - t0 - t_a - t_b
        finally:
            child[0].stop()
    counts = {}
    for d in (nn_counts, row_counts, wire_counts):
        for k, v in d.items():
            counts[k] = counts.get(k, 0) + v
    line = {"nn": nn_line, **row_line, "wire": wire_line,
            "part_s": {"a": round(t_a, 1), "b": round(t_b, 1),
                       "c": round(t_c, 1)}, "card": card}
    log("shard " + json.dumps(line))
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "jubatus_tpu_torch")):
        print("chip_smoke: the jubatus_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"card: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device {kind}, count {torch.cuda.device_count()}")

    # 2. build: the kernels phases 3-9 launch first; lsh.cu and
    # candidates.cu (a minute of nvcc) build on a thread meanwhile, joined
    # before phase 10, their first user
    from jubatus_tpu_torch.kernels import build
    early = ("quantize", "train_scan", "regression_scan")
    late = tuple(k for k in build.KERNELS if k not in early)
    t_build = time.perf_counter()
    times = build.build_all(early)
    late_build = {}

    def build_late():
        try:
            late_build["times"] = build.build_all(late)
        except BaseException as e:  # noqa: BLE001 - raised at the join
            late_build["error"] = e
        late_build["s"] = time.perf_counter() - t_build

    late_thread = threading.Thread(target=build_late, daemon=True)
    late_thread.start()

    def log_build(names, times, elapsed):
        log(f"build: {elapsed:.1f} s "
            + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
        for name in names:
            for line in build.build_log(name).splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    log(f"build: {name}: {line.strip()}")

    log_build(early, times, time.perf_counter() - t_build)
    from jubatus_tpu_torch import native
    t0 = time.perf_counter()
    log(f"build: native converter {native.load().__file__} in "
        f"{time.perf_counter() - t0:.1f} s")

    # each phase's seconds, for the smoke's time budget
    phase_s = {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    # 3-5
    rows = phase_kernels(torch, np)
    lap("3.kernels")
    server_counts = phase_server(torch, np, card)
    lap("4.server")
    mix_counts, diff_shape = phase_mix(torch, np, card)
    rows.update(time_quantizer(torch, np, diff_shape))
    lap("5.mix")
    # 6. regression
    rows["regression_train_scan"] = phase_reg_kernels(torch, np)
    reg_counts = phase_reg_server(torch, np, card)
    reg_mix_counts = phase_reg_mix(torch, np)
    lap("6.regression")
    # 7. cluster: cross-process v3 rounds, one cluster per service
    cluster_counts = [phase_cluster(torch, np, card, svc)
                      for svc in ("classifier", "regression")]
    lap("7.cluster")
    # 8. durable: SIGKILL and recovery, per service
    cluster_counts += [phase_durable(torch, np, card, svc)
                       for svc in ("classifier", "regression")]
    lap("8.durable")
    # 9. read lane: fused reads, per service
    cluster_counts += [phase_read_lane(torch, np, card, svc)
                       for svc in ("classifier", "regression")]
    lap("9.read_lane")
    late_thread.join()
    if "error" in late_build:
        raise late_build["error"]
    log_build(late, late_build["times"], late_build["s"])
    lap("9.build_wait")
    # 10. nearest_neighbor: the LSH kernels, the service, MIX and recovery
    rows.update(phase_nn_kernels(torch, np))
    svc_counts, served_sweeps = phase_nn_service(torch, np, card)
    nn_counts = [svc_counts, phase_nn_cluster(torch, np, card)]
    lap("10.nearest_neighbor")
    # K3's row: the served table's sweep with its selection at a one-datum
    # read; the by-row read and the 10^6-row tables of each kind at 1 and
    # 64 queries follow among its variants
    # 11. the recommender, anomaly and the NN classifier
    rows.update(phase_row_kernels(torch, np))
    row_counts, row_extra = zip(phase_reco_service(torch, np, card),
                                phase_anomaly_service(torch, np, card),
                                phase_nn_classifier(torch, np, card))
    for extra in row_extra:
        rows["lsh_signature"]["variants"] += extra.get("lsh_signature", [])
        rows["sig_topk_variants"] += extra.get("sig_topk", [])
    lap("11.row_engines")
    # 12. the sublinear query index: K6 and K7 at 10^6 rows, over the wire
    # and in anomaly's reads
    t12 = time.perf_counter()
    nn_index_counts, rows["sig_probe"], nn_index_drv = phase_index_nn(
        torch, np)
    ivf_counts, rows["ivf_probe"], ivf_index_drv = phase_index_ivf(torch, np)
    index_counts = [nn_index_counts, ivf_counts,
                    phase_index_wire(torch, np),
                    phase_index_anomaly(torch, np)]
    log(f"index: phase 12 in {time.perf_counter() - t12:.1f} s")
    lap("12.index")
    # 13. the spill tier
    spill_counts, rows["sig_scores"], _ = phase_spill(torch, np)
    rows["dense_dots"]["variants"] += rows["sig_scores"].pop(
        "dots_variants")
    lap("13.spill")
    # 14. the partition plane: in process on phase 12's tables, then over
    # the wire behind the port's proxy, then anomaly's legs
    t14 = time.perf_counter()
    partition_counts = [
        phase_partition_local(torch, np, nn_index_drv, ivf_index_drv)]
    del ivf_index_drv          # phase 18 shards the NN table
    partition_counts += [phase_partition_wire(torch, np),
                         phase_partition_anomaly(torch, np)]
    log(f"partition: phase 14 in {time.perf_counter() - t14:.1f} s")
    lap("14.partition")
    # 15. the operating plane: the train modes, the tracer, the exporter,
    # a traced MIX round and proxy read, --torch_profile
    t15 = time.perf_counter()
    operating_counts = phase_operating(torch, np, card)
    log(f"operating: phase 15 in {time.perf_counter() - t15:.1f} s")
    lap("15.operating")
    # 16. many model slots in one server: routing, quotas, per-slot MIX
    # and recovery, a C plugin, the card's memory back after the drops
    t16 = time.perf_counter()
    tenancy_counts = phase_tenancy(torch, np, card)
    log(f"tenancy: phase 16 in {time.perf_counter() - t16:.1f} s")
    lap("16.tenancy")
    # 17. the data-parallel tier: the replica grids and the fold in
    # process, then standalone DP servers, a hierarchical cluster and a
    # journaled DP server's recovery
    t17 = time.perf_counter()
    dp_rows, dp_counts = phase_dp(torch, np, card)
    rows.update(dp_rows)
    log(f"dp: phase 17 in {time.perf_counter() - t17:.1f} s")
    lap("17.dp")
    # 18. key sharding: phase 12a's table into 4 shards (K3 and K6 a
    # shard a read), a sharded recommender and anomaly beside their
    # twins, a journaled --shard_devices server killed and recovered
    t18 = time.perf_counter()
    shard_counts = phase_shard(torch, np, card, nn_index_drv)
    del nn_index_drv
    log(f"shard: phase 18 in {time.perf_counter() - t18:.1f} s")
    lap("18.shard")
    log("phase_s " + json.dumps(phase_s))
    main_sweep = served_sweeps[0]
    rows["sig_topk"] = {
        **{k: main_sweep[k] for k in (
            "ms", "device_method", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "bytes_bound_ms", "library_ms", "shape",
            "max_abs_err")},
        "variants": served_sweeps + rows.pop("sig_topk_variants")
        + [dict(rows.pop("sig_topk_masked"), route="masked")]}

    def served(kern):
        return sum(c.get(kern, 0) for c in cluster_counts)

    def nn_served(kern):
        return sum(c.get(kern, 0) for c in nn_counts)

    def row_served(kern):
        return sum(c.get(kern, 0) for c in row_counts)

    def index_served(kern):
        return sum(c.get(kern, 0) for c in index_counts)

    def spill_served(kern):
        return sum(c.get(kern, 0) for c in spill_counts)

    def partition_served(kern):
        return sum(c.get(kern, 0) for c in partition_counts)

    def operating_served(kern):
        return operating_counts.get(kern, 0) + tenancy_counts.get(kern, 0)

    def dp_served(kern):
        return dp_counts.get(kern, 0)

    def shard_served(kern):
        return shard_counts.get(kern, 0)

    # 13. report: the quantizer pair's launches are the v3 rounds' (both
    # in-process rounds, both clusters' server processes and the restarted
    # cluster server's replay); the scans' are the server sessions', the
    # server processes' of phases 7-9 and the recovered servers' replays;
    # the LSH kernels' are phase 10's (the in-process build, its server
    # processes and the clusters', the restarted servers' replays too) and
    # phase 11's (the row engines' servers; K4's in process); K6 and
    # K7's are phase 12's (in process, its servers' and anomaly's); K5's
    # scores mode and K4 dense_dots on a spilled table are phase 13's;
    # phase 14 adds the partition plane's: its in-process partial reads,
    # its server processes' and anomaly's legs; phase 15 its servers' (the
    # train modes', the traced round's, the proxy's members', the
    # profiled server's); phase 16 its slots' (each slot's and its
    # one-slot twin's scans, the flood's, the plugin slot's, qa's v3
    # round, the journaled server's replay), counted with phase 15's;
    # phase 18 its sharded reads' K3 and K6 (a launch a shard), K1 of
    # their datums, the sharded row engines' K1, K3 and K5, and its
    # servers' (the journaled sharded one before the kill and after the
    # restart, the plain one on the saved model)
    meta = {
        "quantize_int8": ("jubatus_tpu_torch/csrc/quantize.cu",
                          "jubatus_tpu/parallel/quantized.py:67",
                          mix_counts["quantize_int8"]
                          + reg_mix_counts["quantize_int8"]
                          + served("quantize_int8")
                          + operating_served("quantize_int8")
                          + dp_served("quantize_int8")),
        "dequantize_int8": ("jubatus_tpu_torch/csrc/quantize.cu",
                            "jubatus_tpu/parallel/quantized.py:88",
                            mix_counts["dequantize_int8"]
                            + reg_mix_counts["dequantize_int8"]
                            + served("dequantize_int8")
                            + operating_served("dequantize_int8")
                            + dp_served("dequantize_int8")),
        "train_scan": ("jubatus_tpu_torch/csrc/train_scan.cu",
                       "jubatus_tpu/models/classifier.py:59",
                       server_counts["train_scan"] + served("train_scan")
                       + operating_served("train_scan")),
        "regression_train_scan": ("jubatus_tpu_torch/csrc/regression_scan.cu",
                                  "jubatus_tpu/models/regression.py:32",
                                  reg_counts["regression_train_scan"]
                                  + served("regression_train_scan")),
        # phase 17: the DP servers' replica grids (the standalone
        # servers', the hierarchical cluster's, the journaled server's and
        # its replay); the ring's quantizer launches are counted above
        "train_scan_grid": ("jubatus_tpu_torch/csrc/train_scan.cu",
                            "jubatus_tpu/parallel/dp.py:65",
                            dp_served("train_scan_grid")),
        "regression_train_scan_grid": (
            "jubatus_tpu_torch/csrc/regression_scan.cu",
            "jubatus_tpu/parallel/dp.py:510",
            dp_served("regression_train_scan_grid")),
        "lsh_signature": ("jubatus_tpu_torch/csrc/lsh.cu",
                          "jubatus_tpu/ops/lsh.py:51",
                          nn_served("lsh_signature")
                          + row_served("lsh_signature")
                          + partition_served("lsh_signature")
                          + operating_served("lsh_signature")
                          + shard_served("lsh_signature")),
        "minhash_signature": ("jubatus_tpu_torch/csrc/lsh.cu",
                              "jubatus_tpu/ops/lsh.py:67",
                              nn_served("minhash_signature")),
        "sig_topk": ("jubatus_tpu_torch/csrc/lsh.cu",
                     "jubatus_tpu/ops/lsh.py:189",
                     nn_served("sig_topk") + row_served("sig_topk")
                     + partition_served("sig_topk")
                     + operating_served("sig_topk")
                     + shard_served("sig_topk")),
        # phase 11: K4 and K5 (K3's launches above count the recommender's
        # masked reads and the NN classifier's classifies too)
        "dense_topk": ("jubatus_tpu_torch/csrc/lsh.cu",
                       "jubatus_tpu/ops/lsh.py:327",
                       row_served("dense_topk")
                       + partition_served("dense_topk")),
        "dense_dots": ("jubatus_tpu_torch/csrc/lsh.cu",
                       "jubatus_tpu/models/anomaly.py:83",
                       row_served("dense_dots") + spill_served("dense_dots")),
        "sig_counts": ("jubatus_tpu_torch/csrc/lsh.cu",
                       "jubatus_tpu/ops/lsh.py:106",
                       row_served("sig_counts")
                       + partition_served("sig_counts")
                       + shard_served("sig_counts")),
        # phase 12: the index's reads in process, the servers' and
        # anomaly's
        "sig_probe": ("jubatus_tpu_torch/csrc/candidates.cu",
                      "jubatus_tpu/ops/candidates.py:227",
                      index_served("sig_probe")
                      + partition_served("sig_probe")
                      + shard_served("sig_probe")),
        "ivf_probe": ("jubatus_tpu_torch/csrc/candidates.cu",
                      "jubatus_tpu/ops/candidates.py:367",
                      index_served("ivf_probe")
                      + partition_served("ivf_probe")),
        # phase 13: the spilled reads' sweeps (pool and streamed chunks)
        "sig_scores": ("jubatus_tpu_torch/csrc/lsh.cu",
                       "jubatus_tpu/ops/paged.py:33",
                       spill_served("sig_scores")),
    }
    kernels = []
    for name, (src, replaces, launches) in meta.items():
        if launches <= 0:
            raise AssertionError(f"report: {name} was never launched on the "
                                 "main path")
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in EXTRA_KEYS if key in r}})
    for k in kernels:
        log(f"kernel {k['name']}: {k['ms']} ms at {k['shape']}, bytes bound "
            f"{k.get('bytes_bound_ms', k['bound_ms'])} ms, launches "
            f"{k['launches']}")
    log(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
