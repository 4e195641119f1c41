#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jubatus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc
(/usr/local/cuda or PATH) and PyTorch built for CUDA.  It imports nothing
of JAX or of the JAX package.  Phases, each of which fails the run:

  1. card     — nvidia-smi name/power limit, torch device name
  2. build    — nvcc builds every kernel of the port from csrc/, in parallel
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the shapes the main path gives it: quantize_int8 /
                dequantize_int8 bitwise, train_scan within rtol 1e-5 /
                atol 1e-6 (AROW, PA1, CW); then the scan kernel's time at
                one 8192-datum microbatch beside its plain version's
  4. server   — the classifier server (jubatus_tpu_torch.cli.server, device
                cuda, the bench AROW configuration at hash_max_size 2^20,
                sequential microbatch) answers a wire session: 8192-datum
                train requests over 32 labels, classify, get_labels, save,
                load; the scan kernel must have launched; scores of a small
                stream must agree with the CPU reference driver
  5. mix      — one blockwise-int8 (v3) MIX round between two drivers on the
                card: replicas bitwise equal afterwards, drift from an f32
                round within the accumulated quantization bound, both
                quantizer kernels launched; a `mix_round` line with the
                round's stage times (f32 wire; v3 with the codec on the
                card; v3 with the codec on the host); then the quantizer
                pair's time
                at that round's diff shape beside its plain version's and
                a library yardstick's (torch.quantize_per_channel /
                torch.dequantize, which the port never calls)
  6. report   — one JSON line {"kernels": [...]} (launch counts from phases
                4 and 5; counters are zeroed just before each), then the
                result line {"ok": true, "device": {...}} last.

It exits non-zero and prints no result line when CUDA is unavailable or
when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

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
N_LABELS = 32
REQ_B = 8192            # datums per train request
N_TRAIN_REQS = 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def log(*a):
    print(*a, flush=True)


def bench_batch(rng, n, label_offset=0):
    """n wire datums shaped like bench.py's train requests: 8 string
    features w{t%4}=tok{t}, t < 2^16, plus one number."""
    batch = []
    for i in range(n):
        d = [[], [["x", float(rng.random())]], []]
        for t in rng.integers(0, 1 << 16, size=8):
            d[0].append([f"w{t % 4}", f"tok{t}"])
        batch.append([f"class{(i + label_offset) % N_LABELS}", d])
    return batch


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


class WireClient:
    """msgpack-RPC over one TCP connection (new-spec requests, like
    bench.py's client)."""

    def __init__(self, port):
        import msgpack
        self._msgpack = msgpack
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.unpacker = msgpack.Unpacker(raw=False, strict_map_key=False,
                                         max_buffer_size=1 << 30)
        self.msgid = 0

    def frame(self, method, *args) -> bytes:
        self.msgid += 1
        return self._msgpack.packb([0, self.msgid, method, ["", *args]],
                                   use_bin_type=True)

    def send(self, frame: bytes, method: str = "?"):
        """Send one pre-encoded request and return its result."""
        msgid = self._msgpack.unpackb(frame)[1]
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

    def close(self):
        self.sock.close()


def phase_kernels(torch, np):
    """Phase 3: every kernel against its plain version, then timings."""
    from jubatus_tpu_torch.models.classifier import train_scan, train_scan_ref
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

    small = mixed((32, 512))
    small[0, :4] = [63.5, -63.5, 0.5, 127.0]   # ties at the largest tile value
    quant_case(small)
    mid = mixed((4096, 512))
    mid[32:64] = 0.0                            # an all-zero tile
    quant_case(mid)
    from jubatus_tpu_torch.parallel.quantized import (dequantize_blockwise,
                                                      quantize_blockwise)
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
        "[32,512], [4096,512], blockwise 32x41017 (partial last block)")

    # -- train_scan: B=256, K=16, L=32, D=2^20 for AROW, PA1, CW
    L, D, K = N_LABELS, 1 << 20, 16

    def scan_inputs(b, seed):
        r = np.random.default_rng(seed)
        idx = np.zeros((b, K), np.int32)
        val = np.zeros((b, K), np.float32)
        idx[:, :9] = r.integers(1, D, (b, 9))
        val[:, :9] = r.standard_normal((b, 9)).astype(np.float32)
        idx[: b // 16, 0] = 0       # real features at column 0
        lab = r.integers(0, L, b).astype(np.int32)
        mask = np.ones(b, np.float32)
        mask[-3:] = 0.0
        w = torch.zeros((L, D), dtype=torch.float32, device=dev)
        cov = torch.ones((L, D), dtype=torch.float32, device=dev)
        counts = torch.zeros(L, dtype=torch.int32, device=dev)
        active = torch.zeros(L, dtype=torch.bool, device=dev)
        batch = [torch.from_numpy(a).to(dev) for a in (idx, val, lab, mask)]
        return [w, cov, counts, active], batch

    scan_err = 0.0
    for method in ("AROW", "PA1", "CW"):
        state, batch = scan_inputs(256, 1)
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

    # -- timing at the main path's shape: one 8192-datum AROW microbatch
    state, batch = scan_inputs(REQ_B, 2)
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
    live = batch[3] > 0
    ucols = int(torch.unique(batch[0][live]).numel())
    w_written = int((one[0] != before[0]).sum())
    cov_written = int((one[1] != before[1]).sum())
    scan_bytes = (REQ_B * (2 * K + 2) * 4 + 4 * L * ucols
                  + 4 * (w_written + 2 * cov_written) + 2 * L * 5)
    rows["train_scan"] = dict(
        ms=t_ms, plain_ms=t_plain, library_ms=None, max_abs_err=scan_err,
        bound_ms=scan_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        shape=[REQ_B, K, L, D])
    for name, r in rows.items():
        log(f"kernels: {name} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']})")
    return rows


def time_quantizer(torch, np, diff_shape):
    """Times of the quantizer pair at the main path's shape: the padded
    [nblk*32, 512] view quantize_blockwise gives a [labels, columns] diff
    tensor of the MIX round.  Inputs rotate through enough distinct
    tensors to exceed the 50 MB L2, so each launch reads device memory."""
    from jubatus_tpu_torch.parallel.quantized import (
        _BLOCK, _dequantize_ref, _quantize_ref, dequantize_int8,
        quantize_int8)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n = int(np.prod(diff_shape))
    nblk = -(-n // _BLOCK)
    shape = (nblk * 32, 512)
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
    it = [0]

    def rot(fn):
        def call():
            i = it[0] = (it[0] + 1) % len(xs)
            return fn(i)
        return call

    q_ms = time_cuda(torch, rot(lambda i: quantize_int8(xs[i])), 200)
    q_plain = time_cuda(torch, rot(lambda i: _quantize_ref(xs[i])), 50)
    d_ms = time_cuda(torch, rot(lambda i: dequantize_int8(*qs[i])), 200)
    d_plain = time_cuda(torch, rot(lambda i: _dequantize_ref(*qs[i])), 50)
    # library yardsticks: per-channel affine int8 quantization with the
    # block scales (amax + torch.quantize_per_channel over [nblk, 16384]),
    # and torch.dequantize of that quantized tensor
    zps = torch.zeros(nblk, dtype=torch.int64, device=dev)

    def lib_quant(i):
        blocks = xs[i].view(nblk, _BLOCK)
        s = blocks.abs().amax(dim=1).clamp_min(1e-30).div(127.0)
        return torch.quantize_per_channel(blocks, s.double(), zps, 0,
                                          torch.qint8)

    qts = [lib_quant(i) for i in range(len(xs))]
    q_lib = time_cuda(torch, rot(lib_quant), 50)
    d_lib = time_cuda(torch, rot(lambda i: torch.dequantize(qts[i])), 50)
    elems = nblk * _BLOCK
    rows = {
        "quantize_int8": dict(
            ms=q_ms, plain_ms=q_plain, library_ms=q_lib, max_abs_err=q_err,
            bound_ms=(elems * 4 + elems + nblk * 4) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", shape=list(shape)),
        "dequantize_int8": dict(
            ms=d_ms, plain_ms=d_plain, library_ms=d_lib, max_abs_err=d_err,
            bound_ms=(elems + nblk * 4 + elems * 4) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", shape=list(shape)),
    }
    for name, r in rows.items():
        log(f"kernels: {name} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms by bytes)")
    return rows


def phase_server(torch, np, card):
    """Phase 4: the wire session against the port server on cuda."""
    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.framework.server_base import (kernel_launches,
                                                         reset_kernel_launches)
    from jubatus_tpu_torch.fv import Datum
    from jubatus_tpu_torch.models.classifier import ClassifierDriver

    rng = np.random.default_rng(1)
    reqs = [bench_batch(rng, REQ_B) for _ in range(N_TRAIN_REQS)]
    query = [d for _, d in reqs[0][:N_LABELS]]
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
            reset_kernel_launches()
            t0 = time.perf_counter()
            for frame in frames:
                n = cli.send(frame, "train")
                if n != REQ_B:
                    raise AssertionError(f"train acknowledged {n!r} datums")
            res = cli.call("classify", query)   # reads scores back: a fence
            train_s = time.perf_counter() - t0
            lat = []
            for i in range(20):
                t1 = time.perf_counter()
                cli.call("classify", [query[i % len(query)]])
                lat.append((time.perf_counter() - t1) * 1e3)
            labels = cli.call("get_labels")
            saved = cli.call("save", "smoke")
            loaded = cli.call("load", "smoke")
            after = cli.call("classify", query)
            status = cli.call("get_status")
            cli.close()
            counts = kernel_launches()
        finally:
            rpc.stop()

    sent = REQ_B * N_TRAIN_REQS
    if sum(labels.values()) != sent or len(labels) != N_LABELS:
        raise AssertionError(f"get_labels sums to {sum(labels.values())} "
                             f"over {len(labels)} labels, sent {sent}")
    if len(res) != len(query) or any(len(r) != N_LABELS for r in res):
        raise AssertionError("classify did not return 32 scored labels")
    scores = np.array([[sc for _, sc in r] for r in res])
    if not np.isfinite(scores).all() or not np.abs(scores).max() > 0:
        raise AssertionError("classify scores not finite and non-zero")
    if after != res:
        raise AssertionError("classify changed across save/load")
    if not (len(saved) == 1 and loaded is True):
        raise AssertionError(f"save/load failed: {saved!r} {loaded!r}")
    (st,) = status.values()
    if int(st["kernel_launches.train_scan"]) <= 0 or counts["train_scan"] <= 0:
        raise AssertionError("the scan kernel never launched on the main path")
    if st["device"].split(":")[0] != "cuda":
        raise AssertionError(f"server ran on {st['device']}")

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
    main = {"samples_per_s": sent / train_s,
            "train_request_ms": train_s / N_TRAIN_REQS * 1e3,
            "classify_ms_p50": float(np.median(lat)),
            "train_requests": N_TRAIN_REQS, "datums_per_request": REQ_B,
            "split_ms": {"wire_to_datum": parse_ms,
                         "convert_alone": convert_ms,
                         "driver_train": train_call_ms},
            "card": card}
    log(f"server: {sent} datums in {N_TRAIN_REQS} train requests, "
        f"get_labels sum {sum(labels.values())}, train_scan launches "
        f"{counts['train_scan']}, cuda-vs-cpu scores max |diff| "
        f"{np.abs(got - ref).max():.3g}")
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

    # 2. build
    from jubatus_tpu_torch.kernels import build
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    # 3-5
    rows = phase_kernels(torch, np)
    server_counts = phase_server(torch, np, card)
    mix_counts, diff_shape = phase_mix(torch, np, card)
    rows.update(time_quantizer(torch, np, diff_shape))

    # 6. report
    meta = {
        "quantize_int8": ("jubatus_tpu_torch/csrc/quantize.cu",
                          "jubatus_tpu/parallel/quantized.py:67",
                          mix_counts["quantize_int8"]),
        "dequantize_int8": ("jubatus_tpu_torch/csrc/quantize.cu",
                            "jubatus_tpu/parallel/quantized.py:88",
                            mix_counts["dequantize_int8"]),
        "train_scan": ("jubatus_tpu_torch/csrc/train_scan.cu",
                       "jubatus_tpu/models/classifier.py:59",
                       server_counts["train_scan"]),
    }
    kernels = []
    for name, (src, replaces, launches) in meta.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    log(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
