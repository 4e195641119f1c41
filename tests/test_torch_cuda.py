"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), carry the `cuda` marker and skip elsewhere.  On a machine with a
card, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the suite's conftest sets up JAX, which that machine need
not have; this file imports nothing of it.)  Tolerances: the quantizer
pair is bitwise (on tiled views and on flat runs that end anywhere in a
block; a block holding a NaN gets a NaN scale, as in the host codec); the scan kernel sums in another order than the plain
version, so its tables agree within rtol 1e-5 / atol 1e-6 and its integer
state bitwise, for all seven margin methods: on random batches, on
streams built to hit the prefetch ring's read-after-write hazard (8 to
256 labels, 16 and 64 entries per datum, ring depths 1 to 8, and the
shapes that read cov or w on demand), and two launches of it agree
bitwise.  The ingest pipeline's fused windows (pinned arenas, one copy and
one scan each) leave the model bitwise equal to train_raw frame by frame.
The regression scan kernel agrees with its plain version within the same
tolerance for PA, PA1 and PA2 (PA2 also at C = 3.4e38), on random batches,
on streams where every datum shares a column, with columns repeated within
a datum and across its 32-entry chunks (K 16 to 4096), two launches of it
agree bitwise, and a regression driver on the card estimates like one on
the CPU; also across block boundaries and every block in flight (blocks
of 1 to 64 datums, rings of 1 to 8 slots, 1 to 8 producer warps), at
B 0, 1 and B not a multiple of the block, at every K bucket, and with a
shared-memory layout that agrees with the plan's.  Both scans flush
float32 subnormals as their plain versions do (bitwise on those
datums).  The LSH kernels: the signatures bitwise their plain versions;
the sweep with its top-k selection (sig_topk) bitwise its plain version
(sig_sweep_ref, then torch.topk) for every kind and way rows are read,
by signature and by stored row, at every kb of the fast path and the
sort path's, with fillers, a count of 0, a last block holding fewer rows
than kb, and ties across blocks.  The all-rows count sweep (sig_counts)
bitwise its plain version, one launch a call, for every kind at 2 to 625
words a row (the ring's slabs past 512), tables of 1 to 100,003 rows,
1 to 4,097 queries (past a ring block's query cap), the design the row's
width picks, tables and queries off a 16-byte boundary, and the euclid
estimate's sign at counts 0 and 32 W.  The data-parallel tier: both
scans' replica grid at ndp 1, 3, 4 and 8, each replica bitwise a
one-block launch on its slice (ndp 1 the one-block launch itself),
integer state bitwise and tables within the scan's tolerance of the
plain per-replica loop, and the refusals; the in-process int8 ring (one
quantize and one dequantize launch a hop for all ranks) bitwise the same
ring on the plain quantizer pair.  Key sharding: a sharded read's K3 and
K6 launched once a shard (4 or 2 shards), each bitwise its plain version
on the same slab, the host merge alike, and a sharded driver on the card
answering as one on the CPU.
"""

import numpy as np
import pytest
import torch

from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.mix import codec
from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
from jubatus_tpu_torch.models import classifier as tc
from jubatus_tpu_torch.models import regression as tr
from jubatus_tpu_torch.parallel import quantized as tq

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6
MARGIN = ("perceptron", "PA", "PA1", "PA2", "CW", "AROW", "NHERD")


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _tiles(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.choice(np.array([1e-4, 1.0, 1e3], np.float32), size=shape)
    x[:32, :512] = 0.0                          # an all-zero tile
    if shape[0] > 32:
        x[32, 0] = 127.0                        # scale 1.0: exact ties
        x[33, :4] = [0.5, 1.5, -2.5, 126.5]
    return x


@pytest.mark.parametrize("shape", [(32, 512), (96, 1536), (4096, 512),
                                   (2560, 512), (65536, 512)])
def test_quantizer_pair_is_bitwise_the_plain_version(dev, shape):
    x = torch.from_numpy(_tiles(sum(shape), shape)).to(dev)
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    q, s = tq.quantize_int8(x)
    back = tq.dequantize_int8(q, s)
    torch.cuda.synchronize()
    assert (tq.quantize_int8.launches, tq.dequantize_int8.launches) == \
        (before[0] + 1, before[1] + 1)
    qr, sr = tq._quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(back, tq._dequantize_ref(q, s))


def test_quantizer_rounds_near_ties_like_the_ieee_quotient(dev):
    """The kernel rounds x * (1 / scale) and takes the IEEE division only
    near a half-integer: values at k + 1/2 scales and one, two and eight
    ulps either side, in tiles of random absmax, against the plain
    version's IEEE quotient."""
    rng = np.random.default_rng(11)
    tiles = 64
    absmax = (rng.random(tiles) * 10.0 ** rng.integers(-30, 30, tiles)
              ).astype(np.float32)
    scale = (np.maximum(absmax, np.float32(1e-30)) / np.float32(127.0)
             ).astype(np.float32)
    x = np.zeros((tiles, 32, 512), np.float32)
    half = (rng.integers(-127, 127, (tiles, 32, 512)) + 0.5).astype(np.float32)
    x[:] = half * scale[:, None, None]
    for steps, rows in ((1, slice(0, 8)), (2, slice(8, 16)),
                        (8, slice(16, 24))):
        for _ in range(steps):
            x[:, rows, :256] = np.nextafter(x[:, rows, :256], np.inf)
            x[:, rows, 256:] = np.nextafter(x[:, rows, 256:], -np.inf)
    x[:, 0, 0] = absmax                   # each tile's absmax, exactly
    x = torch.from_numpy(x.reshape(tiles * 32, 512)).to(dev)
    q, s = tq.quantize_int8(x)
    qr, sr = tq._quantize_ref(x)
    assert torch.equal(s, sr)
    assert torch.equal(q, qr), int((q != qr).sum())


@pytest.mark.parametrize("shape", [(7,), (3, 5461), (32, 41017)])
def test_blockwise_kernel_is_bitwise_the_host_codec(dev, shape):
    x = _tiles(7, (1, int(np.prod(shape)))).reshape(shape)
    q, s = tq.quantize_blockwise(torch.from_numpy(x).to(dev))
    qn, sn = tq.quantize_blockwise_np(x)
    np.testing.assert_array_equal(q.cpu().numpy(), qn)
    np.testing.assert_array_equal(s.cpu().numpy(), sn)
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(q, s, shape).cpu().numpy(),
        tq.dequantize_blockwise_np(qn, sn, shape))


@pytest.mark.parametrize("n", [1, 15, 16383, 16384, 16385, 32 * 40883])
def test_blockwise_tails_are_bitwise_the_host_codec(dev, n):
    x = _tiles(n, (1, n)).reshape(-1)
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    q, s = tq.quantize_blockwise(torch.from_numpy(x).to(dev))
    back = tq.dequantize_blockwise(q, s, (n,))
    torch.cuda.synchronize()
    assert (tq.quantize_int8.launches, tq.dequantize_int8.launches) == \
        (before[0] + 1, before[1] + 1)
    qn, sn = tq.quantize_blockwise_np(x)
    np.testing.assert_array_equal(q.cpu().numpy(), qn)
    np.testing.assert_array_equal(s.cpu().numpy(), sn)
    np.testing.assert_array_equal(back.cpu().numpy(),
                                  tq.dequantize_blockwise_np(qn, sn, (n,)))


def _assert_nan_scales_match(s, sr):
    s, sr = s.reshape(-1), sr.reshape(-1)
    nan = torch.isnan(sr)
    assert bool(nan.any()) and torch.equal(torch.isnan(s), nan)
    assert torch.equal(s[~nan], sr[~nan])


def test_nan_block_gets_a_nan_scale_on_the_card(dev):
    """The kernel's scales against the plain version's: NaN at the same
    blocks, the rest bitwise; the int8 values of the blocks without a NaN
    bitwise too (a NaN block's int8 values are not compared: casting NaN
    to int8 is undefined in numpy and torch)."""
    x = _tiles(5, (96, 1536))
    x[40, 700] = np.nan                 # tile (1, 1)
    x[95, 1535] = np.inf                # tile (2, 2): inf keeps its arithmetic
    xt = torch.from_numpy(x).to(dev)
    q, s = tq.quantize_int8(xt)
    qr, sr = tq._quantize_ref(xt)
    _assert_nan_scales_match(s, sr)
    assert bool(torch.isinf(s[2, 2]))
    finite = torch.ones((3, 3), dtype=torch.bool, device=dev)
    finite[1, 1] = finite[2, 2] = False
    keep = finite.repeat_interleave(32, 0).repeat_interleave(512, 1)
    assert torch.equal(q[keep], qr[keep])
    n = 3 * 16384 + 100
    flat = _tiles(6, (1, n)).reshape(-1)
    flat[2 * 16384 + 9] = np.nan
    qb, sb = tq.quantize_blockwise(torch.from_numpy(flat).to(dev))
    qn, sn = tq.quantize_blockwise_np(flat)
    _assert_nan_scales_match(sb.cpu(), torch.from_numpy(sn))
    np.testing.assert_array_equal(qb.cpu().numpy()[:2 * 16384],
                                  qn[:2 * 16384])
    np.testing.assert_array_equal(qb.cpu().numpy()[3 * 16384:],
                                  qn[3 * 16384:])


def test_unaligned_pointers_are_refused(dev):
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    x = torch.zeros(16384 + 1, device=dev)[1:]
    q = torch.zeros(16384 + 1, dtype=torch.int8, device=dev)[1:]
    s = torch.ones(1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        tq.quantize_int8(x.view(32, 512))
    with pytest.raises(ValueError, match="16-byte"):
        tq.quantize_blockwise(x)
    with pytest.raises(ValueError, match="16-byte"):
        tq.dequantize_int8(q.view(32, 512), s.view(1, 1))
    with pytest.raises(ValueError, match="16-byte"):
        tq.dequantize_blockwise(q, s, (16384,))
    assert (tq.quantize_int8.launches, tq.dequantize_int8.launches) == before


def _rounded(nbytes):
    return -(-nbytes // 512) * 512      # the caching allocator's block size


def test_blockwise_calls_allocate_only_their_outputs(dev):
    """One launch each and no staging buffer: the peak allocation of a
    blockwise call on the card is its outputs."""
    n = 32 * 40883
    nblk = -(-n // 16384)
    x = torch.from_numpy(_tiles(8, (32, 40883))).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    q, s = tq.quantize_blockwise(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= \
        _rounded(n) + _rounded(4 * nblk)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    back = tq.dequantize_blockwise(q, s, (32, 40883))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base <= _rounded(4 * n)
    assert tuple(back.shape) == (32, 40883)


def _scan_inputs(seed, L=8, D=4096, B=128, K=16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    cov = (1 + rng.random((L, D))).astype(np.float32)
    counts = rng.integers(0, 3, L).astype(np.int32)
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    val[:, 11:] = 0.0
    idx[:, 11:] = 0
    idx[: B // 8, 0] = 0                        # real features at column 0
    lab = rng.integers(0, L, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    return [w, cov, counts, counts > 0], [idx, val, lab, mask]


@pytest.mark.parametrize("method", MARGIN)
def test_scan_kernel_matches_the_plain_version(dev, method):
    state, batch = _scan_inputs(MARGIN.index(method))
    gpu = [torch.from_numpy(a.copy()).to(dev) for a in state]
    ref = [t.clone() for t in gpu]
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    before = tc.train_scan.launches
    tc.train_scan(*gpu, *bt, method, 0.5)
    torch.cuda.synchronize()
    assert tc.train_scan.launches == before + 1
    tc.train_scan_ref(*ref, *bt, method, 0.5)
    assert torch.equal(gpu[2], ref[2]) and torch.equal(gpu[3], ref[3])
    torch.testing.assert_close(gpu[0], ref[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gpu[1], ref[1], rtol=RTOL, atol=ATOL)
    assert not torch.equal(gpu[0].cpu(), torch.from_numpy(state[0]))


def _hazard_inputs(seed, L=8, K=16, B=160, D=2048):
    """The prefetch ring's read-after-write hazard (as in
    tests/test_torch_classifier.py hazard_inputs, at any L and K): every
    datum carries one shared column and the padding column 0; the first
    half of the batch uses labels 0 and 1 only, so consecutive datums
    repeat a label or take the previous datum's rival as their label;
    duplicate columns inside a datum; real column-0 features; runs of
    padding datums and of not-ok datums (all values 0)."""
    rng = np.random.default_rng(seed)
    live = K * 9 // 16
    w = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    cov = (1 + rng.random((L, D))).astype(np.float32)
    counts = np.zeros(L, np.int32)
    counts[:2] = 1
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    idx[:, live:] = 0
    val[:, live:] = 0.0
    idx[:, live - 1] = 5                  # the shared column
    idx[::7, 0] = 0                       # real column-0 features
    idx[::5, 3] = idx[::5, 1]             # duplicate columns in a datum
    idx[::11, 2] = idx[::11, 1]
    lab = np.where(np.arange(B) < B // 2, rng.integers(0, 2, B),
                   rng.integers(0, L, B)).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[10:13] = 0.0                     # padding datums
    mask[40:42] = 0.0
    val[20:23] = 0.0                      # not ok: |x|^2 = 0
    return [w, cov, counts, counts > 0], [idx, val, lab, mask]


def _kernel_vs_plain(dev, state, batch, method):
    gpu = [torch.from_numpy(a.copy()).to(dev) for a in state]
    ref = [t.clone() for t in gpu]
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    tc.train_scan(*gpu, *bt, method, 0.5)
    torch.cuda.synchronize()
    tc.train_scan_ref(*ref, *bt, method, 0.5)
    assert torch.equal(gpu[2], ref[2]) and torch.equal(gpu[3], ref[3])
    torch.testing.assert_close(gpu[0], ref[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(gpu[1], ref[1], rtol=RTOL, atol=ATOL)
    assert bool((gpu[0][:, 5] != torch.from_numpy(state[0][:, 5]).to(dev))
                .any())                   # the shared column moved
    return tc.train_scan.last_plan


@pytest.mark.parametrize("n_labels,k", [(8, 16), (8, 64), (32, 16), (32, 64),
                                        (64, 16), (64, 64), (256, 16),
                                        (256, 64)])
@pytest.mark.parametrize("method", MARGIN)
def test_scan_kernel_on_hazard_streams(dev, method, n_labels, k):
    _kernel_vs_plain(dev, *_hazard_inputs(n_labels + k, n_labels, k), method)


@pytest.mark.parametrize("ring,producers", [(1, 1), (2, 2), (3, 1), (8, 4)])
@pytest.mark.parametrize("method", MARGIN)
def test_scan_kernel_at_every_ring_depth(dev, monkeypatch, method, ring,
                                        producers):
    monkeypatch.setattr(tc, "SCAN_RING", ring)
    monkeypatch.setattr(tc, "SCAN_PRODUCERS", producers)
    plan = _kernel_vs_plain(dev, *_hazard_inputs(ring, 8, 16, B=96), method)
    assert plan == (tc.SCAN_RING_ALL, ring, producers)


@pytest.mark.parametrize("n_labels,method,mode", [
    (512, "CW", tc.SCAN_RING_W), (512, "AROW", tc.SCAN_RING_W),
    (512, "NHERD", tc.SCAN_RING_W)] + [
    (1024, m, tc.SCAN_DIRECT) for m in MARGIN])
def test_scan_kernel_without_table_prefetch(dev, n_labels, method, mode):
    """Shapes whose slot cannot hold cov (RING_W: cov read on demand after
    the argmax) or even w (DIRECT) for all L rows."""
    plan = _kernel_vs_plain(
        dev, *_hazard_inputs(n_labels, n_labels, 64, B=64, D=1024), method)
    assert plan[0] == mode


def test_scan_smem_layout_agrees_with_the_kernel(dev):
    lib = tc._scan_lib()
    for mode in (tc.SCAN_RING_ALL, tc.SCAN_RING_W, tc.SCAN_DIRECT):
        for n_labels, k, ring in ((8, 16, 1), (32, 16, 4), (256, 64, 2),
                                  (1024, 4096, 3)):
            for has_cov in (False, True):
                assert lib.train_scan_smem_bytes(
                    mode, int(has_cov), ring, n_labels, k) == \
                    tc.scan_smem_bytes(mode, has_cov, ring, n_labels, k)


@pytest.mark.parametrize("method", MARGIN)
def test_scan_kernel_is_deterministic(dev, method):
    """No atomics: two launches from the same state over the same batch
    give bitwise-equal tables."""
    state, batch = _hazard_inputs(3, 32, 16, B=2048, D=1 << 16)
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    outs = []
    for _ in range(2):
        st = [torch.from_numpy(a.copy()).to(dev) for a in state]
        tc.train_scan(*st, *bt, method, 0.5)
        outs.append(st)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _config(method):
    return {"method": method, "parameter": {"regularization_weight": 1.0},
            "converter": {"string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}],
                          "num_rules": [{"key": "*", "type": "num"}],
                          "hash_max_size": 1 << 12}}


def _stream(rng, n):
    return [(f"c{i % 5}", Datum([(f"w{t % 4}", f"tok{t}")
                                 for t in rng.integers(0, 200, 5)],
                                [("x", float(rng.random()))]))
            for i in range(n)]


@pytest.mark.parametrize("method", ("AROW", "PA1", "cosine"))
def test_driver_on_the_card_matches_the_cpu(dev, method):
    drivers = [tc.ClassifierDriver(_config(method), device=d)
               for d in (dev, "cpu")]
    rng = np.random.default_rng(1)
    for _ in range(3):
        data = _stream(rng, 40)
        for d in drivers:
            d.train(data)
    q = [d for _, d in _stream(rng, 8)]
    got, ref = (np.array([[s for _, s in r] for r in d.classify(q)])
                for d in drivers)
    assert drivers[0].get_labels() == drivers[1].get_labels()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_v3_wire_bytes_do_not_depend_on_the_device(dev):
    rng = np.random.default_rng(2)
    diff = {"labels": ["a", "b"], "cols": np.arange(30000, dtype=np.int32),
            "w": (rng.standard_normal((2, 30000)) * 0.05).astype(np.float32),
            "k": 1}
    on_card = codec.packb(encode_wire_diff(diff, True, dev))
    assert on_card == codec.packb(encode_wire_diff(diff, True, "cpu"))


def test_ingest_pipeline_fused_windows_on_the_card(dev):
    """The raw train path on the card: 32 frames queued behind the held
    model lock fuse into windows of up to 16 (each one pinned arena, one
    copy, one scan launch) and leave w, cov and counts bitwise equal to
    train_raw with a synchronize after each frame."""
    import msgpack

    from jubatus_tpu_torch import native
    from jubatus_tpu_torch.batching.arenas import pinned_tensor
    from jubatus_tpu_torch.framework.dispatch import IngestPipeline
    from jubatus_tpu_torch.utils.rwlock import RWLock

    conf = {"method": "AROW", "parameter": {"regularization_weight": 1.0},
            "converter": {
                "string_rules": [{"key": "*", "type": "str",
                                  "sample_weight": "bin",
                                  "global_weight": "bin"}],
                "num_rules": [{"key": "*", "type": "num"}],
                "hash_max_size": 1 << 16}}
    rng = np.random.default_rng(3)
    frames = []
    for i in range(32):
        data = [[f"l{int(rng.integers(0, 8))}",
                 [[[f"w{t % 4}", f"tok{t}"]
                   for t in rng.integers(0, 4096, 8)],
                  [["x", float(rng.random())]], []]]
                for _ in range(int(rng.integers(1, 300)))]
        msg = msgpack.packb([0, i, "train", ["", data]], use_bin_type=True)
        frames.append((msg, native.load().parse_envelope(msg, 0)[4]))

    class Slot:
        def __init__(self, driver):
            self.driver, self.model_lock = driver, RWLock()
            self.update_count = 0

        def event_model_updated(self):
            self.update_count += 1

    drv = tc.ClassifierDriver(conf, device="cuda")
    pinned, step = [], drv.train_converted_batch

    def checked_step(rb):
        host = pinned_tensor(rb.arena)
        pinned.append(host is not None and host.is_pinned())
        return step(rb)

    drv.train_converted_batch = checked_step
    slot = Slot(drv)
    pipe = IngestPipeline(slot)
    try:
        with slot.model_lock.write():         # the dispatch stage waits
            futs = [pipe.submit(m, o) for m, o in frames]
        ns = [f.result(timeout=120) for f in futs]
        pipe.flush()
    finally:
        pipe.stop()
    drv.device_sync()
    ref = tc.ClassifierDriver(conf, device="cuda")
    want = []
    for m, o in frames:
        want.append(ref.train_raw(m, o))
        torch.cuda.synchronize()
    assert ns == want
    assert pipe.windows < pipe.frames == len(frames)
    assert len(pinned) == pipe.windows and all(pinned)
    assert drv.labels == ref.labels
    for name in ("w", "cov", "counts"):
        assert torch.equal(getattr(drv, name), getattr(ref, name)), name


# -- regression scan ------------------------------------------------------------

REG = ("PA", "PA1", "PA2")


def _reg_inputs(seed, kind, B=256, K=16, D=1 << 16):
    """A regression microbatch: about 9/16 of each datum's entries live,
    padding (index 0, value 0) after, three padding datums, two not-ok
    datums (all values 0), targets +-(2..4) with w small.  kind "shared":
    every datum carries one column (5) and every 7th a real column-0
    feature, the read-after-write hazard of consecutive datums; "dup":
    columns repeated within a datum, inside one 32-entry chunk and across
    chunks (K > 32)."""
    rng = np.random.default_rng(seed)
    live = max(1, K * 9 // 16)
    w = (rng.standard_normal(D) * 0.01).astype(np.float32)
    idx = rng.integers(1, D, (B, K)).astype(np.int32)
    val = rng.standard_normal((B, K)).astype(np.float32)
    idx[:, live:] = 0
    val[:, live:] = 0.0
    if kind == "shared":
        idx[:, live - 1] = 5
        idx[::7, 0] = 0
    elif kind == "dup":
        idx[::2, 3 % live] = idx[::2, 1 % live]
        idx[::3, (live - 1)] = idx[::3, 0]      # across chunks when live > 32
        idx[::5, live // 2] = idx[::5, 2 % live]
    tgt = (rng.choice([-1.0, 1.0], B) * (2 + 2 * rng.random(B))
           ).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    if B > 12:
        val[10:12] = 0.0
    return w, [idx, val, tgt, mask]


def _reg_kernel_vs_plain(dev, w, batch, method, c=0.5, eps=0.1):
    gpu = torch.from_numpy(w.copy()).to(dev)
    ref = gpu.clone()
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    before = tr.train_scan.launches
    tr.train_scan(gpu, *bt, method, c, eps)
    torch.cuda.synchronize()
    assert tr.train_scan.launches == before + 1
    tr.train_scan_ref(ref, *bt, method, c, eps)
    torch.testing.assert_close(gpu, ref, rtol=RTOL, atol=ATOL)
    assert not torch.equal(gpu.cpu(), torch.from_numpy(w))
    return gpu


@pytest.mark.parametrize("kind,B,K", [
    ("random", 256, 16), ("shared", 2048, 16), ("dup", 256, 16),
    ("dup", 64, 64), ("random", 8, 4096), ("dup", 8, 4096)])
@pytest.mark.parametrize("method", REG)
def test_regression_scan_matches_the_plain_version(dev, method, kind, B, K):
    w, batch = _reg_inputs(REG.index(method) + K, kind, B, K)
    out = _reg_kernel_vs_plain(dev, w, batch, method)
    if kind == "shared":
        assert float(out[5]) != float(w[5])


def test_regression_scan_pa2_at_the_shipped_regularization_weight(dev):
    w, batch = _reg_inputs(7, "shared", 512)
    _reg_kernel_vs_plain(dev, w, batch, "PA2", c=3.4e38)


@pytest.mark.parametrize("method", REG)
def test_regression_scan_is_deterministic(dev, method):
    """No atomics: two launches from the same w over the same batch give
    bitwise-equal weights."""
    w, batch = _reg_inputs(3, "shared", 4096, 16, 1 << 20)
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    outs = []
    for _ in range(2):
        out = torch.from_numpy(w.copy()).to(dev)
        tr.train_scan(out, *bt, method, 0.5, 0.1)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_regression_scan_refuses_what_it_does_not_take(dev):
    w, batch = _reg_inputs(4, "random", 16)
    gw = torch.from_numpy(w).to(dev)
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    before = tr.train_scan.launches
    wide = torch.zeros((16, 32), dtype=torch.float32, device=dev)
    bad = [
        [bt[0].long(), *bt[1:]],                        # int64 indices
        [bt[0], bt[1].double(), *bt[2:]],               # float64 values
        [bt[0], wide[:, ::2], *bt[2:]],                 # not contiguous
        [bt[0], bt[1], bt[2].cpu(), bt[3]],             # on another device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tr.train_scan(gw, *args, "PA", 1.0, 0.1)
    with pytest.raises(ValueError):
        tr.train_scan(gw, *bt, "AROW", 1.0, 0.1)
    assert tr.train_scan.launches == before


def _subnormal_batch(dev, vals):
    """One datum [vals..., padding], target 1 (regression) / label 0 of 2
    (classifier), on `dev`."""
    k = 4
    idx = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32, device=dev)
    val = torch.zeros((1, k), dtype=torch.float32, device=dev)
    val[0, :2] = torch.tensor(vals, dtype=torch.float32)
    return idx, val


SUBNORMAL = ([3e-20, 3e-20], [1e-39, 1.0])


@pytest.mark.parametrize("vals", SUBNORMAL)
@pytest.mark.parametrize("method", REG)
def test_regression_scan_flushes_subnormals_like_the_plain_version(
        dev, method, vals):
    """Built with -ftz=true, the kernel reads a subnormal as zero and
    flushes subnormal results, as XLA and the plain version do: |x|^2 of
    [3e-20, 3e-20] is 0, so w stays 0; 1e-39 reads as 0, so its column
    stays 0."""
    idx, val = _subnormal_batch(dev, vals)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    got = torch.zeros(8, dtype=torch.float32, device=dev)
    ref = got.clone()
    tr.train_scan(got, idx, val, one, one, method, 1.0, 0.1)
    tr.train_scan_ref(ref, idx, val, one, one, method, 1.0, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert float(got[1]) == 0.0
    assert (float(got[2]) != 0.0) == (vals[1] == 1.0)


@pytest.mark.parametrize("vals", SUBNORMAL)
@pytest.mark.parametrize("method", MARGIN)
def test_scan_kernel_flushes_subnormals_like_the_plain_version(
        dev, method, vals):
    idx, val = _subnormal_batch(dev, vals)
    state = [torch.zeros((2, 8), dtype=torch.float32, device=dev),
             torch.ones((2, 8), dtype=torch.float32, device=dev),
             torch.zeros(2, dtype=torch.int32, device=dev),
             torch.tensor([False, True], device=dev)]
    ref = [t.clone() for t in state]
    lab = torch.zeros(1, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    tc.train_scan(*state, idx, val, lab, one, method, 1.0)
    tc.train_scan_ref(*ref, idx, val, lab, one, method, 1.0)
    torch.cuda.synchronize()
    for a, b in zip(state, ref):
        assert torch.equal(a, b)
    assert float(state[0][:, 1].abs().max()) == 0.0


def test_ftz_on_the_card_is_the_cpu_s(dev):
    """ftz() (hardshrink and copysign) on a CUDA tensor flushes the same
    values to the same signed zeros as on the CPU, NaN passing."""
    from jubatus_tpu_torch.ops.sparse import ftz
    tiny = np.finfo(np.float32).tiny
    sub_max = np.nextafter(tiny, np.float32(0))
    x = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, sub_max,
                      -sub_max, tiny, -tiny, 3e-20, -1.0, np.inf, -np.inf,
                      np.nan] * 5, dtype=torch.float32)
    got = ftz(x.to(dev)).cpu()
    want = ftz(x)
    assert torch.equal(got.isnan(), x.isnan())
    ok = ~x.isnan()
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))


def _reg_pool_inputs(seed, B, K, vocab=40, D=1 << 16):
    """Columns drawn from a pool of `vocab`, so each column recurs within
    datums, across block boundaries and in every block in flight (the
    forwarding hazard), padding after the live entries of some datums."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(D) * 0.01).astype(np.float32)
    idx = rng.integers(0, vocab, (B, K)).astype(np.int32) * 97 % D
    val = rng.standard_normal((B, K)).astype(np.float32)
    short = rng.random(B) < 0.3
    idx[short, K // 2:] = 0
    val[short, K // 2:] = 0.0
    tgt = (rng.choice([-1.0, 1.0], B) * (2 + 2 * rng.random(B))
           ).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[rng.random(B) < 0.05] = 0.0
    return w, [idx, val, tgt, mask]


@pytest.mark.parametrize("entries,ring,producers", [
    (16, 1, 1), (48, 2, 1), (64, 4, 2), (1024, 4, 4), (256, 8, 8),
    (512, 3, 4)])
@pytest.mark.parametrize("method", REG)
def test_regression_scan_across_blocks_and_the_ring(dev, monkeypatch, method,
                                                    entries, ring, producers):
    """Blocks of 1, 3, 4, 16, 32 and 64 datums, rings of 1 to 8 slots and 1
    to 8 producer warps, on a stream whose columns recur across every
    block in flight, B not a multiple of T."""
    monkeypatch.setattr(tr, "REG_BLOCK_ENTRIES", entries)
    monkeypatch.setattr(tr, "REG_RING", ring)
    monkeypatch.setattr(tr, "REG_PRODUCERS", producers)
    w, batch = _reg_pool_inputs(entries + ring, 301, 16)
    _reg_kernel_vs_plain(dev, w, batch, method)
    assert tr.train_scan.last_plan == (max(1, entries // 16), ring,
                                       producers)


@pytest.mark.parametrize("b", (1, 2, 63, 65, 130))
def test_regression_scan_at_small_and_ragged_batches(dev, b):
    w, batch = _reg_pool_inputs(b, b, 16, vocab=12)
    batch[3][:] = 1.0
    _reg_kernel_vs_plain(dev, w, batch, "PA")


def test_regression_scan_of_an_empty_batch_launches_nothing(dev):
    w = torch.ones(64, dtype=torch.float32, device=dev)
    empty = [torch.zeros((0, 16), dtype=torch.int32, device=dev),
             torch.zeros((0, 16), dtype=torch.float32, device=dev),
             torch.zeros(0, dtype=torch.float32, device=dev),
             torch.zeros(0, dtype=torch.float32, device=dev)]
    before = tr.train_scan.launches
    tr.train_scan(w, *empty, "PA", 1.0, 0.1)
    torch.cuda.synchronize()
    assert tr.train_scan.launches == before
    assert torch.equal(w, torch.ones_like(w))


@pytest.mark.parametrize("k", (16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
def test_regression_scan_at_every_k_bucket(dev, k):
    """Every K bucket of the converter, at its planned T, S, P: repeated
    columns within a datum (across its 32-entry chunks) and across
    blocks."""
    t = tr.reg_scan_plan(k)[0]
    w, batch = _reg_pool_inputs(k, 2 * t + 1, k, vocab=3 * k // 2)
    _reg_kernel_vs_plain(dev, w, batch, "PA1")


def test_regression_smem_layout_agrees_with_the_kernel(dev):
    lib = tr._scan_lib()
    for k in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        for t, s in ((1, 1), (3, 2), tr.reg_scan_plan(k)[:2]):
            assert lib.regression_scan_smem_bytes(t, s, k) == \
                tr.reg_scan_smem_bytes(t, s, k)


def _reg_config(method):
    return {"method": method,
            "parameter": {"regularization_weight": 0.5, "sensitivity": 0.1},
            "converter": {"string_rules": [{"key": "*", "type": "str",
                                            "sample_weight": "bin",
                                            "global_weight": "bin"}],
                          "num_rules": [{"key": "*", "type": "num"}],
                          "hash_max_size": 1 << 12}}


def _scored(rng, n):
    out = []
    for _ in range(n):
        toks = rng.integers(0, 200, 5)
        x = float(rng.random())
        out.append((3.0 * x + (2.0 if toks[0] % 2 else -2.0),
                    Datum([(f"w{t % 4}", f"tok{t}") for t in toks],
                          [("x", x)])))
    return out


@pytest.mark.parametrize("method", REG)
def test_regression_driver_on_the_card_matches_the_cpu(dev, method):
    drivers = [tr.RegressionDriver(_reg_config(method), device=d)
               for d in (dev, "cpu")]
    rng = np.random.default_rng(1)
    for _ in range(3):
        data = _scored(rng, 40)
        for d in drivers:
            d.train(data)
    q = [d for _, d in _scored(rng, 8)]
    got, ref = (np.array(d.estimate(q)) for d in drivers)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert drivers[0].num_trained == drivers[1].num_trained == 120


# ---------------------------------------------------------------------------
# the LSH kernels (csrc/lsh.cu) against their plain versions
# ---------------------------------------------------------------------------

from jubatus_tpu_torch.models import nearest_neighbor as tnn  # noqa: E402
from jubatus_tpu_torch.ops import lsh as tl  # noqa: E402

LSH_KEY = tl.prng_key(0x1EAF)


def _lsh_batch(dev, seed, b, k, d=4096):
    """Random datums plus, from three datums on, an empty one, a
    half-padded one and one whose features repeat."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (b, k)).astype(np.int32)
    val = rng.standard_normal((b, k)).astype(np.float32)
    if b >= 3:
        idx[0], val[0] = 0, 0.0
        idx[1, k // 2:], val[1, k // 2:] = 0, 0.0
        idx[2, :] = idx[2, 0]
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev))


# the tile design (a datum alone, up to 1,023 signature words) and the
# stream design (1,024 words and more; (1100, 40) in two feature chunks)
SIG_SHAPES = [(1, 8), (1, 16), (1, 32), (1, 64), (64, 16), (1024, 16),
              (33, 48), (4, 64), (1100, 40)]


@pytest.mark.parametrize("h", [1, 32, 64, 77, 512])
@pytest.mark.parametrize("b, k", SIG_SHAPES)
def test_lsh_signature_kernel_matches_plain(dev, h, b, k):
    """K1 against its plain version on the card: bitwise (both sum in
    projection_order's order with the same fused steps and flushes, and
    both take XLA's log1p, xla_log1p, and a correctly rounded sqrt)."""
    idx, val = _lsh_batch(dev, h + b + k, b, k)
    n0 = tl.lsh_signature.launches
    got = tl.lsh_signature(LSH_KEY, idx, val, h)
    torch.cuda.synchronize()
    assert tl.lsh_signature.launches == n0 + 1
    ref = tl.lsh_signature_ref(LSH_KEY, idx, val, h)
    assert got.shape == (idx.shape[0], tl.words_for(h))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("h", [1, 64, 77, 512])
@pytest.mark.parametrize("b, k", SIG_SHAPES)
def test_minhash_signature_kernel_matches_plain(dev, h, b, k):
    idx, val = _lsh_batch(dev, 7 * h + b + k, b, k)
    n0 = tl.minhash_signature.launches
    got = tl.minhash_signature(LSH_KEY, idx, val, h)
    torch.cuda.synchronize()
    assert tl.minhash_signature.launches == n0 + 1
    assert torch.equal(got, tl.minhash_signature_ref(LSH_KEY, idx, val, h))
    if b >= 3:
        assert bool((got[0] == idx[0, 0]).all())


def test_signature_kernels_on_subnormal_values(dev):
    """Values below 2^-126 read as zero in both (XLA's DAZ): such a
    feature adds nothing to K1 and never wins in K2."""
    idx, val = _lsh_batch(dev, 5, 4, 16)
    val[:, ::3] = 1e-40
    for fn, ref in ((tl.lsh_signature, tl.lsh_signature_ref),
                    (tl.minhash_signature, tl.minhash_signature_ref)):
        assert torch.equal(fn(LSH_KEY, idx, val, 64),
                           ref(LSH_KEY, idx, val, 64))


@pytest.mark.parametrize("kind", ["lsh", "minhash"])
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("edge", ["empty", "half", "repeated"])
def test_signature_kernels_on_one_edge_datum(dev, kind, k, edge):
    """A datum alone (a set_row's, a datum read's: the tile design) that
    is all padding, half padding, or one feature repeated, bitwise its
    plain version, signed at one datum and as in a padded batch of 8 (the
    *_many routes'); a datum of zeros projects to +0 (every lsh bit 1)
    and keeps minhash slot index 0."""
    idx, val = _lsh_batch(dev, 31 * k + len(edge), 1, k)
    if edge == "empty":
        idx.zero_()
        val.zero_()
    elif edge == "half":
        idx[0, k // 2:] = 0
        val[0, k // 2:] = 0.0
    else:
        idx[0, :] = idx[0, 0]
    for h in (64, 77):
        for padded_b in (None, 8):
            if kind == "lsh":
                got = tl.lsh_signature(LSH_KEY, idx, val, h, padded_b)
                ref = tl.lsh_signature_ref(LSH_KEY, idx, val, h, padded_b)
            else:
                got = tl.minhash_signature(LSH_KEY, idx, val, h)
                ref = tl.minhash_signature_ref(LSH_KEY, idx, val, h)
            assert torch.equal(got, ref), (h, padded_b)
            if edge == "empty" and kind == "lsh":
                assert int(got[0, 0]) == -1
            elif edge == "empty":
                assert bool((got[0] == idx[0, 0]).all())


def test_lsh_signature_kernel_in_a_padded_batchs_order(dev):
    """One datum signed as in a padded batch (padded_b 8: k order, on the
    tile design) and alone (eight lanes) each equal their plain versions,
    and the first equals that datum's row of a batch of 64 (k order, on
    the stream design)."""
    idx, val = _lsh_batch(dev, 77, 64, 16)
    for r in range(64):
        i, v = idx[r:r + 1].contiguous(), val[r:r + 1].contiguous()
        alone = tl.lsh_signature(LSH_KEY, i, v, 512)
        padded = tl.lsh_signature(LSH_KEY, i, v, 512, padded_b=8)
        assert torch.equal(alone, tl.lsh_signature_ref(LSH_KEY, i, v, 512))
        assert torch.equal(padded, tl.lsh_signature_ref(LSH_KEY, i, v, 512,
                                                        padded_b=8))
        assert torch.equal(padded, tl.lsh_signature(
            LSH_KEY, idx, val, 512)[r:r + 1])


def test_lsh_signature_launch_refuses_an_order_its_width_lacks(dev):
    """The eight-lane orders need K 16 (ORDER_LANES16) or a multiple of
    16 above it (ORDER_LANES); the launcher refuses any other pairing."""
    lib = tl._lib()
    idx, val = _lsh_batch(dev, 3, 1, 20)
    out = torch.empty((1, 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for order in (tl.ORDER_LANES16, tl.ORDER_LANES, 3, -1):
        err = lib.lsh_signature_launch(
            idx.data_ptr(), val.data_ptr(), out.data_ptr(), LSH_KEY[0],
            LSH_KEY[1], 1, 20, 64, order, stream)
        assert err != 0, order


def test_signature_kernels_refuse_width_zero(dev):
    idx = torch.zeros((2, 0), dtype=torch.int32, device=dev)
    val = torch.zeros((2, 0), dtype=torch.float32, device=dev)
    for fn in (tl.lsh_signature, tl.minhash_signature):
        with pytest.raises(ValueError, match="width 0"):
            fn(LSH_KEY, idx, val, 64)


def _sweep_inputs(dev, kind, h, r, seed):
    rng = np.random.default_rng(seed)
    w = tl.sig_width(kind, h)
    if kind == "minhash":
        tab = rng.integers(0, 6, (r, w)).astype(np.int32)
    else:
        tab = rng.integers(-2**31, 2**31, (r, w)).astype(np.int32)
        if h % 32:
            tab[:, -1] &= (1 << (h % 32)) - 1
    norms = (rng.random(r) * 4).astype(np.float32)
    return torch.from_numpy(tab).to(dev), torch.from_numpy(norms).to(dev)


def _topk_both(dev, kind, h, table, norms, valid, rows, kb):
    """K3 by signature and by stored row, both against the plain
    version (sig_sweep_ref + torch.topk), bitwise; one launch each."""
    qs, qn = table[rows].contiguous(), norms[rows].contiguous()
    n0 = tl.sig_topk.launches
    got = tl.sig_topk(kind, table, norms, valid, q_sigs=qs, qnorms=qn,
                      hash_num=h, kb=kb)
    by_row = tl.sig_topk(kind, table, norms, valid, q_rows=rows,
                         hash_num=h, kb=kb)
    torch.cuda.synchronize()
    assert tl.sig_topk.launches == n0 + 2
    ref = tl.sig_topk_ref(kind, table, norms, valid, qs, qn, h, kb)
    assert got.shape == (rows.shape[0], kb)
    assert torch.equal(got, ref), (kind, h, valid, kb)
    assert torch.equal(by_row, ref), (kind, h, valid, kb)


@pytest.mark.parametrize("kind", tl.SIG_KINDS)
@pytest.mark.parametrize("h", [64, 77, 512])
@pytest.mark.parametrize("nq", [1, 5, 64, 130])
def test_sig_sweep_kernel_matches_plain(dev, kind, h, nq):
    """K3's top keys (the sweep with its selection) bitwise equal the
    plain version's for every kind and every way rows are read (direct:
    lsh/euclid_lsh H 64 and 77; staged: euclid_lsh H 512, minhash H 64;
    split: minhash H 77 and 512), by signature and by stored row, with
    every row valid and with a count below the table's rows, at kb 16
    and 64 (the euclid estimate's fused steps round as the plain
    version's float64 ones)."""
    table, norms = _sweep_inputs(dev, kind, h, 3000, nq + h)
    rng = np.random.default_rng(nq)
    rows = torch.from_numpy(rng.integers(0, 3000, nq)).to(dev)
    for valid in (2990, 3000):
        for kb in (16, 64):
            _topk_both(dev, kind, h, table, norms, valid, rows, kb)


@pytest.mark.parametrize("kind", tl.SIG_KINDS)
@pytest.mark.parametrize("kb", [1, 8, 16, 33, 64, 256, 1024, 2048])
def test_sig_topk_kernel_every_kb(dev, kind, kb):
    """Every kb, the fast path's (<= 1024: one key a lane up to 32, slots
    of 2 to 32 a lane above) and the sort path's (2048), on R 5001 (not
    a multiple of the 256-row tile): no valid row (all fillers), fewer
    valid rows than kb (fillers after them, the lowest rows first), a
    count whose last block holds fewer rows than kb, and every row."""
    table, norms = _sweep_inputs(dev, kind, 64, 5001, kb + 11)
    rng = np.random.default_rng(kb)
    rows = torch.from_numpy(rng.integers(0, 5001, 3)).to(dev)
    for valid in (0, 5, max(kb // 2, 1), 4097, 4999, 5001):
        _topk_both(dev, kind, 64, table, norms, valid, rows, kb)


@pytest.mark.parametrize("kind", tl.SIG_KINDS)
@pytest.mark.parametrize("kb", [8, 64, 1024])
def test_sig_topk_kernel_ties_across_blocks(dev, kind, kb):
    """Ties across warps and blocks: a table of identical signatures (the
    top is pure row order, rows 0..kb-1) and one of three signatures
    repeated (each score's rows spread over every block), 70,001 rows,
    69,999 valid: many blocks, every list's keys tied in score."""
    w = tl.sig_width(kind, 64)
    rng = np.random.default_rng(kb)
    pats = rng.integers(-2**31, 2**31, (3, w)).astype(np.int32)
    if kind == "minhash":
        pats = rng.integers(0, 4, (3, w)).astype(np.int32)
    norms = torch.full((70001,), 1.5, dtype=torch.float32, device=dev)
    rows = torch.tensor([0, 5, 69998], dtype=torch.int64, device=dev)
    for pick in (np.zeros(70001, np.int64), rng.integers(0, 3, 70001)):
        table = torch.from_numpy(pats[pick]).to(dev)
        plan = tl.topk_plan(70001, w, 3, kb, 69999, kind)
        assert plan["blocks"] > 1
        _topk_both(dev, kind, 64, table, norms, 69999, rows, kb)
        if not pick.any():
            top, _ = tl.keys_to_rows_scores(tl.sig_topk(
                kind, table, norms, 69999, q_rows=rows, hash_num=64, kb=kb))
            assert torch.equal(top, torch.arange(kb, device=dev).expand(
                3, kb))


def test_sig_sweep_kernel_wide_minhash_rows(dev):
    """Rows of 512 words (minhash H 512, wider than the staged path's 64):
    a warp a row, the counts summed across it."""
    table, norms = _sweep_inputs(dev, "minhash", 512, 700, 3)
    assert tl.topk_plan(700, 512, 100, 16, 700, "minhash")["mode"] == "split"
    rows = torch.arange(0, 700, 7, device=dev)
    _topk_both(dev, "minhash", 512, table, norms, 700, rows, 16)


def test_sig_topk_plan_shapes(dev):
    """The plan at the shapes the main path and the tests give it."""
    served = tl.topk_plan(2000128, 2, 1, 16, 1001024)
    assert served["path"] == "fast" and served["mode"] == "direct"
    assert served["blocks"] > 132 and served["rows_per_block"] % 256 == 0
    assert tl.topk_plan(10**6, 64, 64, 16, 10**6, "minhash")["mode"] == \
        "staged"
    assert tl.topk_plan(10**6, 16, 64, 16, 10**6, "euclid_lsh")["mode"] == \
        "staged"
    assert tl.topk_plan(5001, 2, 3, 2048, 4999)["path"] == "sort"
    assert tl.topk_plan(5001, 2, 3, 1024, 4999)["path"] == "fast"
    assert tl.topk_plan(5001, 2, 3, 16, 0)["blocks"] == 0
    with pytest.raises(ValueError):
        tl.topk_plan(10, 2, 1, 11, 10)


def test_sig_sweep_refuses_bad_inputs(dev):
    table, norms = _sweep_inputs(dev, "lsh", 64, 10, 1)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        tl.sig_topk("lsh", table, norms, 10, q_rows=one, hash_num=128)
    with pytest.raises(ValueError):
        tl.sig_topk("lsh", table.float(), norms, 10, q_rows=one, hash_num=64)
    with pytest.raises(ValueError):
        tl.sig_topk("lsh", table, norms, torch.ones(10, device=dev),
                    q_rows=one, hash_num=64)
    for kb in (0, 11):
        with pytest.raises(ValueError):
            tl.sig_topk("lsh", table, norms, 10, q_rows=one, hash_num=64,
                        kb=kb)


@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
def test_nn_driver_on_the_card_matches_the_cpu(dev, method):
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096}}
    drivers = [tnn.NearestNeighborDriver(cfg, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(5)
    data = [Datum([], [(f"f{j}", float(rng.standard_normal()))
                       for j in rng.choice(512, 16, replace=False)])
            for _ in range(300)]
    for d in drivers:
        d.set_row_many([(f"r{i % 250}", x) for i, x in enumerate(data[:280])])
        d.set_row("r7", data[299])
    assert drivers[0].pack() == drivers[1].pack()
    for q in data[280:290]:
        a, b = (d.similar_row_from_datum(q, 10) for d in drivers)
        assert a == b
    a, b = (d.neighbor_row_from_id("r7", 20) for d in drivers)
    assert a == b
    pairs = [(q, 5) for q in data[285:299]]
    a, b = (d.neighbor_row_from_datum_many(pairs) for d in drivers)
    assert a == b


# ---------------------------------------------------------------------------
# K4 (dense_topk, dense_dots), K5 (sig_counts) and K3 with a validity mask:
# bitwise their plain versions; the recommender, anomaly and NN classifier
# on the card answer as on the CPU
# ---------------------------------------------------------------------------

def _sparse(rows, kr, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (rows, kr)).astype(np.int32)
    val = rng.standard_normal((rows, kr)).astype(np.float32)
    nz = rng.integers(1, kr + 1, rows)
    for r in range(rows):
        idx[r, nz[r]:] = 0
        val[r, nz[r]:] = 0.0
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    return idx, val, norms


# (Kr, D, rows): the ring's tiles are 16 to 128 rows (a table of fewer
# than 132 * 128 rows is cut into tiles of 16, 32, ...), one slab of up to
# 32 columns each (Kr 2048: 64 slabs); Kr 32 runs 8 lanes a row, other
# widths a lane a row; Kr 5 copies 4 bytes at a time, Kr 12 three 16-byte
# vectors a row; D 2^16 leaves the query out of shared memory (the exact
# LOF's table at 1,024 rows); 17,099 rows end in a tile of 75
DENSE_DOTS_SHAPES = (
    [(16, 4096, 1500), (32, 4096, 1500), (64, 4096, 1500),
     (128, 1 << 16, 1500), (2048, 4096, 1500)]
    + [(32, 1 << 16, r) for r in list(range(1, 34)) + [257, 1024]]
    + [(16, 4096, 257), (64, 4096, 257), (2048, 4096, 33), (5, 4096, 100),
       (12, 4096, 1000), (32, 4096, 17000 + 99)])


@pytest.mark.parametrize("kr,d,rows", DENSE_DOTS_SHAPES)
@pytest.mark.parametrize("c", [1, 3, 8])
def test_dense_dots_kernel_is_bitwise_its_plain_version(dev, kr, d, rows, c):
    idx, val, _ = _sparse(rows, kr, d, kr + c)
    q = np.random.default_rng(c).standard_normal((c, d)).astype(np.float32)
    q[:, ::3] = 0.0
    cpu = [torch.from_numpy(x) for x in (idx, val, q)]
    n0 = tl.dense_dots.launches
    got = tl.dense_dots(*(x.to(dev) for x in cpu)).cpu()
    assert tl.dense_dots.launches == n0 + 1
    want = tl.dense_dots_ref(*cpu)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kr", [16, 32, 64])
def test_dense_dots_keeps_the_flushed_zero_s_sign(dev, kr):
    """Rows whose products are all tiny negative (a fused step's exact
    result a negative subnormal: -0 at Kr <= 32), all -0, or tiny of both
    signs, beside normal rows: bitwise the plain version."""
    rng = np.random.default_rng(700 + kr)
    d = 4096
    idx, val, _ = _sparse(64, kr, d, kr)
    q = rng.standard_normal((1, d)).astype(np.float32)
    q[0, :16] = np.float32(1e-22)
    q[0, 16:32] = 0.0
    idx[:3] = rng.integers(0, 16, (3, kr))
    val[0] = -rng.uniform(1e-25, 1e-20, kr)
    val[1] = -1.0
    idx[1] = rng.integers(16, 32, kr)
    val[2] = rng.choice([-1, 1], kr) * rng.uniform(1e-25, 1e-20, kr)
    for r, at in ((3, 0), (4, 1)):       # -0 products, one tiny at k 0 or 1
        idx[r] = rng.integers(16, 32, kr)
        val[r] = -1.0
        idx[r, at] = 0
        val[r, at] = -1e-20
    cpu = [torch.from_numpy(x) for x in (idx, val, q)]
    got = tl.dense_dots(*(x.to(dev) for x in cpu)).cpu()
    want = tl.dense_dots_ref(*cpu)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want[0, 0].view(torch.int32) == -2 ** 31) == (kr <= 32)
    # Kr 32's lanes start at +0 (lane 0) and -0: only a tiny product in
    # lane 0 leaves the row at -0
    assert (want[0, 3].view(torch.int32) == -2 ** 31) == (kr <= 32)
    assert (want[0, 4].view(torch.int32) == -2 ** 31) == (kr <= 16)


# (Kr, D, rows, queries): the tables of 3000 rows, then the ring's edges
# (see DENSE_DOTS_SHAPES): single rows and tiles, a last tile of 3 rows
# (4099 = 32 * 128 + 3, the sort path's padding too), 64 slabs a row,
# copies of 4 bytes, the query out of shared memory at the LOF's shape
DENSE_TOPK_SHAPES = (
    [(32, 4096, 3000, 3), (64, 1 << 16, 3000, 3), (128, 4096, 3000, 3)]
    + [(32, 4096, 1, 1), (32, 4096, 17, 8), (32, 4096, 33, 3),
       (16, 4096, 257, 1), (32, 4096, 257, 8), (32, 1 << 16, 1024, 1),
       (2048, 4096, 300, 3), (5, 4096, 100, 3), (32, 4096, 4099, 2)])
# each shape at kb 8, 32, 128, 1024 and 2048 (the sort path), a kb above
# the table's rows taken once, as its row count
DENSE_TOPK_CASES = [
    (*shape, kb) for shape in DENSE_TOPK_SHAPES
    for kb in sorted({min(kb, shape[2]) for kb in (8, 32, 128, 1024, 2048)})]


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("kr,d,rows,nq,kb", DENSE_TOPK_CASES)
def test_dense_topk_kernel_is_bitwise_its_plain_version(dev, metric, kr, d,
                                                        rows, nq, kb):
    idx, val, norms = _sparse(rows, kr, d, kr)
    rng = np.random.default_rng(kb)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q[:, rng.random(d) < 0.5] = 0.0
    qn = np.sqrt((q * q).sum(1)).astype(np.float32)
    mask = rng.random(rows) < 0.6
    cpu = [torch.from_numpy(x) for x in (idx, val, norms, mask, q, qn)]
    g = [x.to(dev) for x in cpu]
    for n_valid, m in ((rows, True), (max(rows - 50, rows // 2), False),
                       (kb // 2, True)):
        n0 = tl.dense_topk.launches
        got = tl.dense_topk(metric, g[0], g[1], g[2], n_valid,
                            g[3] if m else None, g[4], g[5], kb).cpu()
        assert tl.dense_topk.launches == n0 + 1
        want = tl.dense_topk_ref(metric, cpu[0], cpu[1], cpu[2], n_valid,
                                 cpu[3] if m else None, cpu[4], cpu[5], kb)
        assert torch.equal(got, want), (n_valid, m)


def test_dense_kernels_refuse_rows_off_a_16_byte_boundary(dev):
    """The ring copies rows 16 bytes at a time where Kr is a multiple of 4:
    a table that starts 4 bytes into its storage is refused, never read
    another way."""
    idx, val, norms = _sparse(64, 32, 4096, 5)
    flat_i = torch.zeros(64 * 32 + 1, dtype=torch.int32, device=dev)
    flat_v = torch.zeros(64 * 32 + 1, dtype=torch.float32, device=dev)
    flat_i[1:] = torch.from_numpy(idx.reshape(-1)).to(dev)
    flat_v[1:] = torch.from_numpy(val.reshape(-1)).to(dev)
    i_off, v_off = flat_i[1:].view(64, 32), flat_v[1:].view(64, 32)
    q = torch.ones((1, 4096), dtype=torch.float32, device=dev)
    n0 = (tl.dense_dots.launches, tl.dense_topk.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tl.dense_dots(i_off, v_off, q)
    with pytest.raises(ValueError, match="16-byte"):
        tl.dense_topk("cosine", i_off, v_off,
                      torch.from_numpy(norms).to(dev), 64, None, q,
                      torch.ones(1, device=dev), 8)
    assert (tl.dense_dots.launches, tl.dense_topk.launches) == n0


@pytest.mark.parametrize("kind", ["lsh", "minhash", "euclid_lsh"])
@pytest.mark.parametrize("h", [64, 128, 512])
def test_sig_counts_kernel_is_bitwise_its_plain_version(dev, kind, h):
    rng = np.random.default_rng(h)
    w, rows = tl.sig_width(kind, h), 5000
    tab = rng.integers(0, 2 ** 32, (rows, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "minhash":
        tab %= 5
    qs = tab[rng.integers(0, rows, 7)].copy()
    qs[:, 0] ^= 3
    norms = (rng.random(rows) * 4).astype(np.float32)
    qn = (rng.random(7) * 4).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (tab.view(np.int32),
                                         qs.view(np.int32), norms, qn)]
    n0 = tl.sig_counts.launches
    got = tl.sig_counts(kind, *(x.to(dev) for x in cpu), h).cpu()
    assert tl.sig_counts.launches == n0 + 1
    want = tl.sig_counts_ref(kind, *cpu, h)
    assert got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


_COUNT_TABLES = {}


def _count_inputs(kind, h, rows, nq, seed):
    """A seeded signature table [rows, W] (minhash words in 0..4, so rows
    match queries often), nq queries drawn from it (rows 0 and 1: the
    first word flipped) and norms, as numpy; the table kept for the
    other query counts."""
    key = (kind, h, rows, seed)
    if key not in _COUNT_TABLES:
        _COUNT_TABLES.clear()
        rng = np.random.default_rng(seed)
        w = tl.sig_width(kind, h)
        tab = rng.integers(0, 2 ** 32, (rows, w), dtype=np.uint32)
        if kind == "minhash":
            tab %= 5
        norms = (rng.random(rows) * 4).astype(np.float32)
        _COUNT_TABLES[key] = (tab, norms)
    tab, norms = _COUNT_TABLES[key]
    rng = np.random.default_rng(seed + nq)
    qs = tab[rng.integers(0, rows, nq)].copy()
    qs[: min(nq, 2), 0] ^= 3
    qn = (rng.random(nq) * 4).astype(np.float32)
    return tab, qs, norms, qn


def _counts_both(dev, kind, h, tab, qs, norms, qn):
    """K5 on the card (one launch, by the wrapper's count) and its plain
    version on the same card tensors."""
    g = [torch.from_numpy(x).to(dev) for x in (tab.view(np.int32),
                                               qs.view(np.int32), norms, qn)]
    n0 = tl.sig_counts.launches
    got = tl.sig_counts(kind, *g, h)
    assert tl.sig_counts.launches == n0 + 1
    want = tl.sig_counts_ref(kind, *g, h)
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


@pytest.mark.parametrize("kind,h", [
    ("lsh", 64), ("lsh", 128), ("lsh", 512), ("minhash", 64),
    ("minhash", 128), ("minhash", 256), ("minhash", 512),
    ("euclid_lsh", 64), ("euclid_lsh", 128), ("euclid_lsh", 512)])
@pytest.mark.parametrize("rows", [1, 31, 255, 257, 16384, 100003])
@pytest.mark.parametrize("nq", [1, 7, 64])
def test_sig_counts_kernel_every_width_rows_and_queries(dev, kind, h, rows,
                                                        nq):
    """Both designs' shapes (2 to 512 words a row: a lane a row up to 16
    words, 2 to 32 lanes above), tables of one row to more tiles than the
    card's SMs, the last tile partial, and one, a few and many queries
    (minhash H 512 at 64 queries runs 4 query groups)."""
    got, want = _counts_both(dev, kind, h,
                             *_count_inputs(kind, h, rows, nq, 7))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind,h", [("lsh", 64), ("lsh", 128),
                                    ("lsh", 512), ("minhash", 8),
                                    ("minhash", 64), ("euclid_lsh", 64),
                                    ("euclid_lsh", 96)])
@pytest.mark.parametrize("rows", [1, 257, 100003])
@pytest.mark.parametrize("nq", [1, 64])
def test_sig_counts_design_follows_the_row_width(dev, kind, h, rows, nq):
    """The row's width picks the design: the direct design up to 16
    words a row (W 2, 3, 4, 8 and 16 here), the ring above; either
    bitwise its plain version."""
    w = tl.sig_width(kind, h)
    assert tl.sig_counts_plan(kind, rows, h, nq)["design"] == int(w > 16)
    got, want = _counts_both(dev, kind, h,
                             *_count_inputs(kind, h, rows, nq, 8))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind,h", [
    ("euclid_lsh", 1024), ("minhash", 64), ("lsh", 1024), ("minhash", 512),
    ("lsh", 64)])
def test_sig_counts_beyond_the_query_cap_launches_once(dev, kind, h):
    """One more query than a ring block's group holds (the cap: SC_QSMEM
    bytes of query words): two groups in the one launch, the table read
    twice.  The direct design (lsh H 64) keeps no query in shared memory:
    one group at any count (4,097 queries here)."""
    plan = tl.sig_counts_plan(kind, 257, h, 65535)
    direct = plan["design"] == 0
    assert direct == (tl.sig_width(kind, h) <= 16)
    cap = plan["queries_a_group"]
    if direct:
        assert cap == 65535
        cap = 4096
    plan = tl.sig_counts_plan(kind, 257, h, cap + 1)
    if direct:
        assert plan["queries_a_group"] == cap + 1 and plan["groups"] == 1
    else:
        assert plan["queries_a_group"] == cap and plan["groups"] == 2
    got, want = _counts_both(dev, kind, h,
                             *_count_inputs(kind, h, 257, cap + 1, 9))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind,h", [("minhash", 1000), ("minhash", 1024),
                                    ("lsh", 20000), ("euclid_lsh", 20000)])
@pytest.mark.parametrize("rows,nq", [(257, 1), (257, 7), (16384, 3)])
def test_sig_counts_rows_in_slabs(dev, kind, h, rows, nq):
    """Rows of more than 512 words go through the ring in slabs of 512,
    the slabs' counts added in shared memory (W 1000, 1024, 625: a last
    slab of 488, 512 and 113 words; W 625 copies 4 bytes at a time)."""
    got, want = _counts_both(dev, kind, h,
                             *_count_inputs(kind, h, rows, nq, 10))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind,h", [
    ("lsh", 64), ("minhash", 64), ("euclid_lsh", 96), ("lsh", 512),
    ("lsh", 1024)])
def test_sig_counts_reads_a_table_off_a_16_byte_boundary(dev, kind, h):
    """A table and queries that start 4 bytes into their storage: rows
    read by 4-byte words (direct) or copied 4 bytes at a time (ring), the
    queries word by word, never refused."""
    tab, qs, norms, qn = _count_inputs(kind, h, 3001, 5, 11)

    def off(a):
        flat = torch.zeros(a.size + 1, dtype=torch.int32, device=dev)
        flat[1:] = torch.from_numpy(a.view(np.int32).reshape(-1)).to(dev)
        return flat[1:].view(a.shape)
    t = off(tab)
    plan = tl.sig_counts_plan(kind, 3001, h, 5, t.data_ptr())
    assert plan["copy_bytes"] in (0, 4)
    g = [off(qs)] + [torch.from_numpy(x).to(dev) for x in (norms, qn)]
    n0 = tl.sig_counts.launches
    got = tl.sig_counts(kind, t, g[0], g[1], g[2], h)
    assert tl.sig_counts.launches == n0 + 1
    want = tl.sig_counts_ref(kind, t, g[0], g[1], g[2], h)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("h", [64, 96, 512, 1024])
def test_sig_counts_euclid_estimate_sign_and_flush(dev, h):
    """The euclid estimate at counts 0 (a row equal to the query: cos 1,
    d2 = (qn - n)^2 up to rounding) and 32 W (its complement: cos of
    pi 32 W / H = -1), at norms of 0, subnormals, squares that fall below
    float32's normal range and plain ones: bitwise the plain version (no
    step flushed to zero: the kernel is built without -ftz, as the plain
    version's float32 steps round), never a negative zero or a NaN
    (max(d2, 0) before the sqrt), and +0 at equal norms whose squares are
    normal."""
    w = tl.sig_width("euclid_lsh", h)
    vals = np.array([0.0, 1e-45, 1e-40, 1e-30, 1e-20, 1e-19, 0.5, 1.0, 3.0,
                     3.0000002], np.float32)
    rng = np.random.default_rng(h)
    q = rng.integers(0, 2 ** 32, (1, w), dtype=np.uint32)
    tab = np.concatenate([np.repeat(q, len(vals), 0),
                          np.repeat(~q, len(vals), 0)])
    norms = np.concatenate([vals, vals])
    qs = np.repeat(q, len(vals), 0)
    g = [torch.from_numpy(x).to(dev) for x in (tab.view(np.int32),
                                               qs.view(np.int32), norms,
                                               vals)]
    got = tl.sig_counts("euclid_lsh", *g, h)
    want = tl.sig_counts_ref("euclid_lsh", *g, h)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    bits = got.view(torch.int32)
    assert bool((bits >= 0).all()) and not bool(torch.isnan(got).any())
    normal = torch.from_numpy((vals == 0) | (vals >= 0.5)).to(dev)
    eq = got[:, : len(vals)].diagonal()
    assert bool((eq.view(torch.int32)[normal] == 0).all())


def test_sig_counts_plan_shapes(dev):
    """The rule's designs and their geometry: the direct design up to 16
    words a row, a block a tile of 256 rows (the served LOF sweep: 16,384
    rows, W 2, one query; lsh H 512 at 10^6 rows, 64 queries), tiles of
    32 rows with 8 threads a row where 16,384 rows meet 64 queries; the
    ring above, 2 to 32 lanes a row, every SM a tile where the table
    allows it."""
    p = tl.sig_counts_plan("euclid_lsh", 16384, 64, 1)
    assert p["design"] == 0 and p["groups"] == 1 and p["smem_bytes"] == 0
    assert p["tile_rows"] == 256 and p["blocks"] == 64
    p = tl.sig_counts_plan("euclid_lsh", 16384, 64, 64)
    assert p["design"] == 0 and p["lanes_a_row"] == 8
    assert p["tile_rows"] == 32 and p["blocks"] == 512
    p = tl.sig_counts_plan("lsh", 10 ** 6, 512, 64)
    assert p["design"] == 0 and p["lanes_a_row"] == 1
    assert p["copy_bytes"] == 16 and p["blocks"] == -(-10 ** 6 // 256)
    for kind, h, lanes, wr in (("minhash", 32, 2, 16), ("minhash", 64, 4, 16),
                               ("minhash", 128, 8, 16),
                               ("minhash", 512, 32, 16), ("lsh", 1024, 2, 16)):
        p = tl.sig_counts_plan(kind, 10 ** 6, h, 64)
        assert p["design"] == 1 and p["lanes_a_row"] == lanes
        assert p["words_a_lane"] == wr and p["stages"] >= 3
        assert p["queries_a_group"] * tl.sig_width(kind, h) * 4 <= 32 * 1024 \
            or p["queries_a_group"] == 1
        assert p["copy_bytes"] == 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = tl.sig_counts_plan("minhash", 16384, 64, 1)
    assert p["blocks"] >= min(sms, -(-16384 // p["tile_rows"]))
    assert -(-16384 // p["tile_rows"]) >= sms or p["tile_rows"] == 16


@pytest.mark.parametrize("kind", ["lsh", "minhash", "euclid_lsh"])
@pytest.mark.parametrize("kb", [8, 128, 2048])
@pytest.mark.parametrize("rows", [5000, 200000])
def test_masked_sig_topk_is_bitwise_its_plain_version(dev, kind, kb, rows):
    h = 64
    rng = np.random.default_rng(rows + kb)
    w = tl.sig_width(kind, h)
    tab = rng.integers(0, 2 ** 32, (rows, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "minhash":
        tab %= 7
    qs = tab[rng.integers(0, rows, 5)].copy()
    norms = (rng.random(rows) * 3).astype(np.float32)
    qn = (rng.random(5) * 3).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (tab.view(np.int32), norms,
                                         qs.view(np.int32), qn)]
    g = [x.to(dev) for x in cpu]
    for keep, n_valid, dtype in ((0.6, rows, torch.bool),
                                 (0.001, rows - 100, torch.uint8)):
        mask = torch.from_numpy(rng.random(rows) < keep).to(dtype)
        got = tl.sig_topk(kind, g[0], g[1], n_valid, q_sigs=g[2],
                          qnorms=g[3], hash_num=h, kb=kb,
                          mask=mask.to(dev)).cpu()
        want = tl.sig_topk_ref(kind, cpu[0], cpu[1], n_valid, cpu[2],
                               cpu[3], h, kb, mask)
        assert torch.equal(got, want), (keep, n_valid)


@pytest.mark.parametrize("method", ["inverted_index", "inverted_index_euclid",
                                    "lsh", "euclid_lsh"])
def test_recommender_on_the_card_matches_the_cpu(dev, method):
    from jubatus_tpu_torch.models.recommender import RecommenderDriver
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096}}
    drivers = [RecommenderDriver(cfg, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(6)
    data = [Datum([], [(f"f{j}", float(rng.standard_normal()))
                       for j in rng.choice(512, int(rng.integers(2, 60)),
                                           replace=False)])
            for _ in range(300)]
    for d in drivers:
        for i, x in enumerate(data[:260]):
            d.update_row(f"r{i % 200}", x)
            if i % 11 == 5:
                d.clear_row(f"r{i - 3}")
    for q in data[260:275]:
        a, b = (d.similar_row_from_datum(q, 12) for d in drivers)
        assert a == b
    a, b = (d.similar_row_from_datum_many([(q, 4) for q in data[280:290]])
            for d in drivers)
    assert a == b


@pytest.mark.parametrize("nn_method", ["inverted_index_euclid", "euclid_lsh",
                                       "minhash"])
def test_anomaly_on_the_card_matches_the_cpu(dev, nn_method):
    from jubatus_tpu_torch.models.anomaly import AnomalyDriver
    cfg = {"method": "lof",
           "parameter": {"nearest_neighbor_num": 5, "method": nn_method,
                         "parameter": {"hash_num": 64}},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096}}
    drivers = [AnomalyDriver(cfg, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(7)
    data = [Datum([], [(f"f{j}", float(rng.standard_normal()))
                       for j in rng.choice(300, 8, replace=False)])
            for _ in range(120)]
    for i, x in enumerate(data[:100]):
        a, b = (d.add(f"a{i}", x) for d in drivers)
        assert a == b
    assert drivers[0].calc_score_many(data[100:]) == \
        drivers[1].calc_score_many(data[100:])


def test_nn_classifier_on_the_card_matches_the_cpu(dev, monkeypatch):
    import uuid
    cfg = {"method": "NN",
           "parameter": {"method": "euclid_lsh",
                         "parameter": {"hash_num": 64}},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096}}
    drivers = [tc.NNClassifierDriver(cfg, device=d) for d in (dev, "cpu")]
    rng = np.random.default_rng(8)
    data = [(f"l{i % 3}", Datum([], [(f"f{j}", float(rng.standard_normal()))
                                     for j in rng.choice(300, 10,
                                                         replace=False)]))
            for i in range(300)]
    for d in drivers:
        seq = iter(range(10 ** 6))
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(seq) + 1))
        d.train(data[:280])
    a, b = (d.classify([x for _, x in data[280:]]) for d in drivers)
    assert a == b


# ---------------------------------------------------------------------------
# K6 (sig_probe) and K7 (ivf_probe): bitwise their plain versions on the
# same card tensors, one launch a call
# ---------------------------------------------------------------------------

from jubatus_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from jubatus_tpu_torch.index.base import IndexSpec  # noqa: E402
from jubatus_tpu_torch.ops import candidates as tcand  # noqa: E402
from torch_index_inputs import (clustered_sigs, sig_index,  # noqa: E402
                                      sparse_rows)


def _probe_csr(store, dev):
    flat, off, ln, dl, cap = store.packed()
    return tuple(torch.from_numpy(x).to(dev) for x in (flat, off, ln, dl)) \
        + (cap,)


@pytest.mark.parametrize("kind,h", [("lsh", 64), ("minhash", 64),
                                    ("euclid_lsh", 64), ("lsh", 512),
                                    ("euclid_lsh", 512), ("minhash", 256)])
@pytest.mark.parametrize("route", ["sig", "row"])
@pytest.mark.parametrize("valid", ["count", "mask"])
@pytest.mark.parametrize("k,fresh", [(10, 10), (10, 0), (200, 16)])
def test_sig_probe_is_bitwise_the_plain_version(dev, kind, h, route, valid,
                                                k, fresh):
    n = 3000
    sig, norms = clustered_sigs(kind, h, n, seed=h + len(kind))
    store, plan, bits = sig_index(kind, h, sig, probes=4, fresh=fresh)
    csr = _probe_csr(store, dev)
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.from_numpy(norms).to(dev)
    rng = np.random.default_rng(3)
    mask = None
    n_valid = n - 7
    if valid == "mask":
        mask = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        n_valid = n
    kb = tcand._kb(k, plan, csr[4], csr[3])
    qr = torch.from_numpy(rng.integers(0, n, 5)).to(dev)
    qs, qn = table[qr], tn[qr]
    before = tcand.sig_probe.launches
    if route == "row":
        got = tcand.sig_probe(kind, table, tn, n_valid, mask, csr, plan,
                              bits, h, kb, q_rows=qr)
    else:
        got = tcand.sig_probe(kind, table, tn, n_valid, mask, csr, plan,
                              bits, h, kb, q_sigs=qs.contiguous(),
                              qnorms=qn.contiguous())
    assert tcand.sig_probe.launches == before + 1
    want = tcand.sig_probe_ref(kind, table, tn, n_valid, mask, qs, qn,
                               *csr[:4], csr[4], plan, bits, h, kb)
    assert torch.equal(got, want)
    if k == 200:
        assert kb > 1024


@pytest.mark.parametrize("probes", [4, 8])
def test_sig_probe_fat_buckets_and_the_workspace(dev, probes):
    # 40,000 rows of 20 prototypes: buckets of thousands, so the candidate
    # buffer passes shared memory (the workspace path)
    sig, norms = clustered_sigs("lsh", 64, 40000, seed=11)
    store, plan, bits = sig_index("lsh", 64, sig, probes=probes,
                                  delta_cap=2048, fresh=300)
    csr = _probe_csr(store, dev)
    width = tcand._cand_width(plan, csr[4], csr[3])
    # kb = width sorts its keys in device memory
    assert width > tcand.PROBE_SORT_SMEM_KEYS
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.from_numpy(norms).to(dev)
    qr = torch.arange(0, 40000, 997, device=dev)
    for kb in (16, 80, 2048, width):
        got = tcand.sig_probe("lsh", table, tn, 40000, None, csr, plan,
                              bits, 64, kb, q_rows=qr)
        want = tcand.sig_probe_ref("lsh", table, tn, 40000, None, table[qr],
                                   tn[qr], *csr[:4], csr[4], plan, bits, 64,
                                   kb)
        assert torch.equal(got, want), kb


def _ivf_inputs(dev, metric, probes, seed, n=4000, d=512, embed_dim=64,
                centroids=0):
    idx, val = sparse_rows(n, 32, d, seed, centers=40)
    ix = IvfIndex(metric, IndexSpec(kind="ivf", probes=probes, min_rows=0,
                                    embed_dim=embed_dim,
                                    centroids=centroids))
    ix.rebuild_from(np.arange(n), idx, val)
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (idx, val, norms)]
    return ix, t, idx, val


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("probes", [1, 4, 8])
@pytest.mark.parametrize("valid", ["count", "mask"])
@pytest.mark.parametrize("embed_dim", [64, 16])
def test_ivf_probe_is_bitwise_the_plain_version(dev, metric, probes, valid,
                                                embed_dim):
    n = 4000
    ix, (ti, tv, tn), idx, val = _ivf_inputs(dev, metric, probes, seed=probes,
                                             embed_dim=embed_dim)
    csr = _probe_csr(ix.store, dev)
    cent = torch.from_numpy(ix.centroids).to(dev)
    rng = np.random.default_rng(probes)
    mask, n_valid = None, n - 5
    if valid == "mask":
        mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        n_valid = n
    for q in rng.integers(0, n, 6):
        qi = torch.from_numpy(idx[q]).to(dev)
        qv = torch.from_numpy(val[q] * np.float32(1.25)).to(dev)
        qd = torch.zeros(512, dtype=torch.float32, device=dev)
        qd[qi.long()] = qv
        qn = float(np.sqrt((val[q] * val[q] * np.float32(1.5625)).sum()))
        kb = tcand._ivf_kb(10, probes, csr[4], csr[3])
        before = tcand.ivf_probe.launches
        got = tcand.ivf_probe(metric, qi, qv, qd, qn, cent, ti, tv, tn,
                              n_valid, mask, csr, probes, embed_dim, kb)
        assert tcand.ivf_probe.launches == before + 1
        want = tcand.ivf_probe_ref(
            metric, qi, qv, qd, torch.tensor(np.float32(qn), device=dev),
            cent, ti, tv, tn, n_valid, mask, *csr[:4], csr[4], probes,
            embed_dim, kb)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kb", [1, 48, 1500, 4096])
def test_ivf_probe_at_every_kb_and_1024_centroids(dev, kb):
    ix, (ti, tv, tn), idx, val = _ivf_inputs(dev, "cosine", 8, seed=9,
                                             n=6000, centroids=1024)
    csr = _probe_csr(ix.store, dev)
    cent = torch.from_numpy(ix.centroids).to(dev)
    assert cent.shape[0] == 1024
    width = 16 * csr[4] + csr[3].shape[0]
    kb = min(kb, width)
    qi = torch.from_numpy(idx[17]).to(dev)
    qv = torch.from_numpy(val[17]).to(dev)
    qd = torch.zeros(512, dtype=torch.float32, device=dev)
    qd[qi.long()] = qv
    qn = float(np.sqrt((val[17] * val[17]).sum()))
    got = tcand.ivf_probe("cosine", qi, qv, qd, qn, cent, ti, tv, tn, 6000,
                          None, csr, 8, 64, kb)
    want = tcand.ivf_probe_ref(
        "cosine", qi, qv, qd, torch.tensor(np.float32(qn), device=dev),
        cent, ti, tv, tn, 6000, None, *csr[:4], csr[4], 8, 64, kb)
    assert torch.equal(got, want)


def test_probe_wrappers_refuse_bad_inputs(dev):
    sig, norms = clustered_sigs("lsh", 64, 100, seed=1)
    store, plan, bits = sig_index("lsh", 64, sig, probes=4)
    csr = _probe_csr(store, dev)
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.from_numpy(norms).to(dev)
    one = torch.zeros(1, dtype=torch.int64, device=dev)
    width = tcand._cand_width(plan, csr[4], csr[3])
    for kb in (0, width + 1):
        with pytest.raises(ValueError):
            tcand.sig_probe("lsh", table, tn, 100, None, csr, plan, bits,
                            64, kb, q_rows=one)
    with pytest.raises(ValueError):
        tcand.sig_probe("lsh", table, tn, 100, None, csr, plan, bits, 128,
                        8, q_rows=one)
    with pytest.raises(IndexError):
        tcand.sig_probe_query_row("lsh", table, 100, tn, 100, None, csr, 64,
                                  8, plan, bits)
    with pytest.raises(ValueError):
        tcand.sig_probe("lsh", table.float(), tn, 100, None, csr, plan,
                        bits, 64, 8, q_rows=one)
    ix, (ti, tv, tn2), idx, val = _ivf_inputs(dev, "cosine", 4, seed=2,
                                              n=300)
    cent = torch.from_numpy(ix.centroids).to(dev)
    icsr = _probe_csr(ix.store, dev)
    qi = torch.from_numpy(idx[0]).to(dev)
    qv = torch.from_numpy(val[0]).to(dev)
    qd = torch.zeros(512, device=dev)
    with pytest.raises(ValueError):
        tcand.ivf_probe("cosine", qi, qv, qd, 1.0, cent, ti, tv, tn2, 300,
                        None, icsr, cent.shape[0] + 1, 64, 8)
    with pytest.raises(ValueError):
        tcand.ivf_probe("cosine", qi, qv, qd, 1.0, cent, ti, tv, tn2, 300,
                        None, icsr, 4, 32, 8)


@pytest.mark.parametrize("service,method,kind", [
    ("nearest_neighbor", "lsh", "lsh_probe"),
    ("nearest_neighbor", "euclid_lsh", "lsh_probe"),
    ("recommender", "minhash", "lsh_probe"),
    ("recommender", "inverted_index", "ivf"),
    ("recommender", "inverted_index_euclid", "ivf")])
def test_index_drivers_on_the_card_match_the_cpu(dev, service, method, kind):
    """A driver with the index engaged answers every read on the card as
    on the CPU, each read one K6 (K7) launch on the card."""
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096},
           "index": {"min_rows": 0}}
    from jubatus_tpu_torch.models import create_driver
    drivers = [create_driver(service, cfg, device=d) for d in (dev, "cpu")]
    for d in drivers:
        assert d.configure_index(kind, probes=4)
    rng = np.random.default_rng(12)
    protos = [[(f"f{j}", float(rng.standard_normal()))
               for j in rng.choice(300, 8, replace=False)] for _ in range(20)]
    data = [Datum([], [(k, v + 0.05 * float(rng.standard_normal()))
                       for k, v in protos[i % 20]]) for i in range(260)]
    write = "update_row" if service == "recommender" else "set_row"
    for d in drivers:
        for i, x in enumerate(data[:250]):
            getattr(d, write)(f"r{i}", x)
    kern = tcand.ivf_probe if kind == "ivf" else tcand.sig_probe
    before = kern.launches
    for q in data[250:]:
        a, b = (d.similar_row_from_datum(q, 10) for d in drivers)
        assert a == b and len(a) == 10
    a, b = (d.similar_row_from_id("r7", 5) for d in drivers)
    assert a == b
    assert kern.launches == before + 11


# ---------------------------------------------------------------------------
# K6 and K7 at the edges of their stages: chunks of PROBE_CHUNK positions
# a stage-1 block, the chunks' lists in shared or device memory, the kb
# sorted in shared or device memory, the embedding in shared or device
# memory, the centroid pick's keys in shared or device memory
# ---------------------------------------------------------------------------

def _synthetic_csr(dev, n_rows, n_groups, cap, dcap, seed):
    """A CSR of n_groups groups over a flat list of rows (each row listed
    about twice: duplicates), group lengths 0 to cap, and a delta of dcap
    rows (-1 padded past its first half)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, n_rows, 3 * n_groups + cap).astype(np.int32)
    flat[-cap:] = -1
    off = rng.integers(0, flat.shape[0] - cap, n_groups).astype(np.int32)
    ln = rng.integers(0, cap + 1, n_groups).astype(np.int32)
    ln[rng.random(n_groups) < 0.5] = cap
    delta = np.full(dcap, -1, np.int32)
    delta[:dcap // 2 + 1] = rng.integers(0, n_rows, dcap // 2 + 1)
    return tuple(torch.from_numpy(x).to(dev) for x in (flat, off, ln,
                                                       delta)) + (cap,)


# (probes, cap, delta): a width below one chunk, of exactly one, and of
# several, chunk boundaries inside groups and inside the delta
PROBE_WIDTHS = [(2, 300, 100), (4, 200, 224), (4, 700, 1500)]


@pytest.mark.parametrize("kind,h", [("lsh", 64), ("minhash", 64),
                                    ("euclid_lsh", 64), ("lsh", 96)])
@pytest.mark.parametrize("shape", PROBE_WIDTHS)
@pytest.mark.parametrize("valid", ["count", "mask", "none"])
def test_sig_probe_chunk_edges(dev, kind, h, shape, valid):
    """Rows of 2 and 64 words (read two words a load) and of 3 (one)."""
    probes, cap, dcap = shape
    n = 5000
    sig, norms = clustered_sigs(kind, h, n, seed=len(kind) + cap)
    bits = 8
    plan = tcand.band_plan(kind, h, bits, probes)
    nb = tcand.n_bands_for(kind, h, bits)
    csr = _synthetic_csr(dev, n, nb << bits, cap, dcap, seed=cap + dcap)
    width = tcand._cand_width(plan, cap, csr[3])
    assert width == probes * cap + dcap
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.from_numpy(norms).to(dev)
    mask, n_valid = None, n - 11
    if valid == "mask":
        mask = torch.from_numpy(np.random.default_rng(1).random(n) > 0.3) \
            .to(dev)
        n_valid = n
    elif valid == "none":
        n_valid = 0
    qr = torch.tensor([3, 777, 4999], device=dev)
    for kb in sorted({1, min(80, width), width}):
        before = tcand.sig_probe.launches
        got = tcand.sig_probe(kind, table, tn, n_valid, mask, csr, plan,
                              bits, h, kb, q_rows=qr)
        assert tcand.sig_probe.launches == before + 1
        want = tcand.sig_probe_ref(kind, table, tn, n_valid, mask, table[qr],
                                   tn[qr], *csr[:4], cap, plan, bits, h, kb)
        assert torch.equal(got, want), kb
        if valid == "none":
            assert int(got[:, 2 * kb].abs().sum()) == 0
            _, sc, _ = tcand.probe_result(got, kb)
            assert np.all(np.isneginf(sc))


@pytest.mark.parametrize("nq", [1, 64])
@pytest.mark.parametrize("kb", [1, 48, 700, 4500])
def test_sig_probe_batch_route_and_kb_past_shared_memory(dev, nq, kb):
    """The batch route's Nq queries a call: at kb 1 and 48 stage 2 ranks
    the few keys above its bound, at 700 more are left (the select over
    the lists in shared memory), at 4500 the lists and the sort pass
    shared memory."""
    n = 20000
    sig, norms = clustered_sigs("lsh", 64, n, seed=5)
    plan = tcand.band_plan("lsh", 64, 8, 8)
    csr = _synthetic_csr(dev, n, 8 << 8, 1500, 2048, seed=6)
    width = tcand._cand_width(plan, 1500, csr[3])
    n_chunks = -(-width // tcand.PROBE_CHUNK)
    assert n_chunks * min(4500, tcand.PROBE_CHUNK) > \
        tcand.PROBE_LIST_SMEM_KEYS
    assert tcand._pow2(4500) > tcand.PROBE_SORT_SMEM_KEYS
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.from_numpy(norms).to(dev)
    qr = torch.from_numpy(np.random.default_rng(nq).integers(0, n, nq)) \
        .to(dev)
    qs, qn = table[qr].contiguous(), tn[qr].contiguous()
    before = tcand.sig_probe.launches
    got = tcand.sig_probe("lsh", table, tn, n, None, csr, plan, 8, 64, kb,
                          q_sigs=qs, qnorms=qn)
    assert tcand.sig_probe.launches == before + 1
    want = tcand.sig_probe_ref("lsh", table, tn, n, None, qs, qn, *csr[:4],
                               1500, plan, 8, 64, kb)
    assert torch.equal(got, want)


def _ivf_synthetic(dev, e, c, n=3000, kr=32, d=512, seed=0, misalign=False):
    """Random centroids [c, e] and rows (kr entries of d columns), and a
    dense query with colliding count-sketch coordinates; misalign: the
    row tables start 4 bytes past a 16-byte boundary (the scalar reads)."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, e)).astype(np.float32)
    idx, val = sparse_rows(n, kr, d, seed, centers=40)
    norms = np.sqrt((val * val).sum(1)).astype(np.float32)

    def put(x):
        if not misalign:
            return torch.from_numpy(x).to(dev)
        buf = torch.empty(x.size + 1, dtype=torch.from_numpy(x).dtype,
                          device=dev)
        out = buf[1:].view(x.shape)
        out.copy_(torch.from_numpy(x))
        return out

    ti, tv = put(idx), put(val)
    qi = torch.from_numpy(np.concatenate([idx[9, :12], idx[9, :4]])).to(dev)
    qv = torch.from_numpy(rng.standard_normal(16).astype(np.float32)).to(dev)
    qd = torch.zeros(d, dtype=torch.float32, device=dev)
    qd.index_put_((qi.long(),), qv, accumulate=True)
    qn = float(torch.sqrt((qd * qd).sum()).cpu())
    return (torch.from_numpy(cent).to(dev), ti, tv,
            torch.from_numpy(norms).to(dev), qi, qv, qd, qn)


def _ivf_check(dev, metric, inputs, csr, n_valid, mask, probes, e, kb):
    cent, ti, tv, tn, qi, qv, qd, qn = inputs
    before = tcand.ivf_probe.launches
    got = tcand.ivf_probe(metric, qi, qv, qd, qn, cent, ti, tv, tn, n_valid,
                          mask, csr, probes, e, kb)
    assert tcand.ivf_probe.launches == before + 1
    want = tcand.ivf_probe_ref(
        metric, qi, qv, qd, torch.tensor(np.float32(qn), device=dev), cent,
        ti, tv, tn, n_valid, mask, *csr[:4], csr[4], probes, e, kb)
    assert torch.equal(got, want), kb
    return got


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("embed_dim", [2, 4, 8, 2048, 16384, 32768])
def test_ivf_probe_at_new_embed_dims(dev, metric, embed_dim):
    """K7 at the widths below 8 (one gemv chain a centroid), above 1,024
    (the squares' windows windowed again) and above the shared-memory
    embedding (built in device memory first), 37 centroids (rows past
    the gemv's last tile of 8); 20 probes pick their centroids by the
    select, fewer one at a time."""
    inputs = _ivf_synthetic(dev, embed_dim, 37, seed=embed_dim)
    csr = _synthetic_csr(dev, 3000, 74, 700, 1500, seed=3)
    for probes in (1, 3, 20):
        kb = tcand._ivf_kb(10, probes, 700, csr[3])
        _ivf_check(dev, metric, inputs, csr, 2990, None, probes, embed_dim,
                   kb)


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
@pytest.mark.parametrize("c,embed_dim", [(5, 8), (13, 8), (37, 8),
                                         (1024, 8), (20, 8), (2, 1),
                                         (37, 1), (1024, 1), (3, 131072),
                                         (2, 1 << 20)])
def test_ivf_probe_at_every_width_and_centroid_count(dev, metric, c,
                                                     embed_dim):
    """K7 at E 8 with configured centroid counts whose squares' sums
    XLA splits between its vectorized and scalar loops, at E 1 (the
    shift by 32, one fused multiply-add a centroid) and above 65,536 (the
    squares' windows three levels deep), bitwise its plain version."""
    inputs = _ivf_synthetic(dev, embed_dim, c, seed=c + embed_dim)
    csr = _synthetic_csr(dev, 3000, 2 * c, 700, 1500, seed=c)
    for probes in sorted({1, min(3, c)}):
        kb = tcand._ivf_kb(10, probes, 700, csr[3])
        _ivf_check(dev, metric, inputs, csr, 2990, None, probes, embed_dim,
                   kb)


@pytest.mark.parametrize("shape", PROBE_WIDTHS)
@pytest.mark.parametrize("valid", ["count", "mask", "none"])
def test_ivf_probe_chunk_edges(dev, shape, valid):
    probes, cap, dcap = shape
    probes = max(1, probes // 2)           # two bands a probe
    inputs = _ivf_synthetic(dev, 64, 40, seed=cap)
    csr = _synthetic_csr(dev, 3000, 80, cap, dcap, seed=dcap)
    width = 2 * probes * cap + dcap
    mask, n_valid = None, 2900
    if valid == "mask":
        mask = torch.from_numpy(np.random.default_rng(2).random(3000) > 0.4) \
            .to(dev)
        n_valid = 3000
    elif valid == "none":
        n_valid = 0
    for kb in sorted({1, min(48, width), width}):
        got = _ivf_check(dev, "cosine", inputs, csr, n_valid, mask, probes,
                         64, kb)
        if valid == "none":
            assert int(got[0, 2 * kb]) == 0


@pytest.mark.parametrize("metric", ["cosine", "euclid"])
def test_ivf_probe_scalar_reads_many_centroids_and_a_wide_kb(dev, metric):
    """Rows of 30 entries and rows off a 16-byte boundary (the scalar
    gather-dot), 9,000 centroids (the pick reads its keys from device
    memory) and a kb whose sort and list pass shared memory."""
    csr = _synthetic_csr(dev, 3000, 18000, 1500, 2048, seed=8)
    for kr, mis in ((30, False), (32, True)):
        inputs = _ivf_synthetic(dev, 8, 9000, kr=kr, seed=kr, misalign=mis)
        for kb in (30, 4500):
            _ivf_check(dev, metric, inputs, csr, 3000, None, 8, 8, kb)


def test_sig_probe_ties_spread_thinly_over_chunks(dev):
    """chip_smoke.py phase 12a's table shape: rows copied from
    prototypes with one bit flipped, so a stored row's prototype copies
    tie on one score and spread a few a chunk over every probed group:
    stage 2's bound stays below the tie and several hundred keys remain
    (its sort path), each query bitwise the plain version."""
    rng = np.random.default_rng(31)
    n, protos = 500_000, 2048
    proto = rng.integers(0, 2 ** 32, (protos, 2), dtype=np.uint64) \
        .astype(np.uint32)
    sig = proto[rng.integers(0, protos, n)]
    sig[np.arange(n), rng.integers(0, 2, n)] ^= \
        np.uint32(1) << rng.integers(0, 32, n, dtype=np.uint32)
    store, plan, bits = sig_index("lsh", 64, sig, probes=4, fresh=0,
                                  delta_cap=2048)
    csr = _probe_csr(store, dev)
    table = torch.from_numpy(sig.view(np.int32)).to(dev)
    tn = torch.ones(n, dtype=torch.float32, device=dev)
    kb = tcand._kb(10, plan, csr[4], csr[3])
    for q in rng.integers(0, n, 8):
        qr = torch.tensor([int(q)], device=dev)
        got = tcand.sig_probe("lsh", table, tn, n, None, csr, plan, bits, 64,
                              kb, q_rows=qr)
        want = tcand.sig_probe_ref("lsh", table, tn, n, None, table[qr],
                                   tn[qr], *csr[:4], csr[4], plan, bits, 64,
                                   kb)
        assert torch.equal(got, want), int(q)


# ---------------------------------------------------------------------------
# the spill tier: K5's scores mode, and a spilled store's sweeps on the card
# ---------------------------------------------------------------------------

from jubatus_tpu_torch.models.pages import PagedRowStore  # noqa: E402
from jubatus_tpu_torch.models.pages import PageSpec  # noqa: E402
from jubatus_tpu_torch.ops import paged as tpaged  # noqa: E402


@pytest.mark.parametrize("kind,h", [("lsh", 64), ("lsh", 512),
                                    ("minhash", 64), ("euclid_lsh", 64),
                                    ("euclid_lsh", 128)])
@pytest.mark.parametrize("rows", [48, 2048, 16384, 65536, 250000])
@pytest.mark.parametrize("nq", [1, 3, 64])
def test_sig_scores_mode_is_bitwise_its_plain_version(dev, kind, h, rows,
                                                      nq):
    """K5's scores mode (one launch by the wrapper's count) at the spill
    tier's pool and chunk shapes, both designs, against sig_scores_ref on
    the same card tensors."""
    tab, qs, norms, qn = _count_inputs(kind, h, rows, nq, 11)
    g = [torch.from_numpy(x).to(dev) for x in (tab.view(np.int32),
                                               qs.view(np.int32), norms, qn)]
    n0 = tl.sig_scores.launches
    got = tl.sig_scores(kind, *g, h)
    assert tl.sig_scores.launches == n0 + 1
    want = tl.sig_scores_ref(kind, *g, h)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _spilled_pair(dev, columns, gen, n, holes, seed, page_rows=16,
                  budget=5):
    """A spilled store on the card and one on the CPU after the same
    history (batches of writes, drops, refills)."""
    rng = np.random.default_rng(seed)
    out = [PagedRowStore(columns, capacity=page_rows, device=d,
                         spec=PageSpec(page_rows, budget))
           for d in (dev, torch.device("cpu"))]
    done = 0
    while done < n:
        b = int(min(n - done, rng.integers(50, 900)))
        vals = gen(rng, b)
        for st in out:
            st.write(st.alloc(b), vals)
        done += b
    if holes:
        drop = rng.choice(n, holes, replace=False)
        for st in out:
            st.free(drop)
        vals = gen(rng, holes // 2)
        for st in out:
            st.write(st.alloc(holes // 2), vals)
    return out


@pytest.mark.parametrize("kind", ["lsh", "minhash", "euclid_lsh"])
@pytest.mark.parametrize("chunk_rows,run_bytes_min", [(65536, 0), (256, 0),
                                                      (256, 1 << 62)])
def test_spilled_sig_scores_on_the_card_equal_the_cpu(dev, monkeypatch, kind,
                                                      chunk_rows,
                                                      run_bytes_min):
    """A spilled store's sig_scores on the card (K5's scores mode on the
    pool and on each streamed chunk: one chunk; many, the last partial;
    many gathered into pinned staging) against the same store on the CPU,
    bitwise, with the kernel launched once a chunk and once for the
    pool."""
    monkeypatch.setattr(tpaged, "SPILL_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(tpaged, "RUN_BYTES_MIN", run_bytes_min)
    w = tl.sig_width(kind, 64)

    def gen(rng, b):
        sig = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint64) \
            .astype(np.uint32)
        if kind == "minhash":
            sig %= 5
        return {"sig": sig,
                "norms": (rng.random(b) * 4).astype(np.float32)}
    card, cpu = _spilled_pair(dev, {"sig": ((w,), np.uint32),
                                    "norms": ((), np.float32)},
                              gen, 5000, 300, seed=len(kind))
    rng = np.random.default_rng(2)
    q = rng.integers(0, 2 ** 32, (3, w), dtype=np.uint64).astype(np.uint32)
    if kind == "minhash":
        q %= 5
    qn = (rng.random(3) * 4).astype(np.float32)
    n0 = tl.sig_scores.launches
    timing = {}
    got = tpaged.sig_scores(card, kind, 64, q, qn, timing=timing)
    absent = timing["streamed_pages"]
    chunk_pages = chunk_rows // 16
    assert tl.sig_scores.launches - n0 == 1 + -(-absent // chunk_pages)
    want = tpaged.sig_scores(cpu, kind, 64, q, qn)
    assert got.tobytes() == want.tobytes()
    assert absent > 0 and timing["copy_ms"] >= 0


@pytest.mark.parametrize("kr", [32, 64])
@pytest.mark.parametrize("chunk_rows", [65536, 512])
def test_spilled_dense_dots_on_the_card_equal_the_cpu(dev, monkeypatch, kr,
                                                      chunk_rows):
    monkeypatch.setattr(tpaged, "SPILL_CHUNK_ROWS", chunk_rows)

    def gen(rng, b):
        idx = rng.integers(0, 4096, (b, kr)).astype(np.int32)
        val = rng.standard_normal((b, kr)).astype(np.float32)
        val[:, kr // 2:] = 0.0
        return {"indices": idx, "values": val,
                "norms": np.sqrt((val * val).sum(1)).astype(np.float32)}
    card, cpu = _spilled_pair(dev, {"indices": ((kr,), np.int32),
                                    "values": ((kr,), np.float32),
                                    "norms": ((), np.float32)},
                              gen, 4000, 200, seed=kr)
    qd = np.random.default_rng(3).standard_normal((8, 4096)) \
        .astype(np.float32)
    n0 = tl.dense_dots.launches
    got = tpaged.dense_dots(card, qd)
    assert tl.dense_dots.launches - n0 >= 2
    assert got.tobytes() == tpaged.dense_dots(cpu, qd).tobytes()
    for metric in ("cosine", "euclid"):
        assert tpaged.dense_scores(card, metric, qd[0], 3.0).tobytes() == \
            tpaged.dense_scores(cpu, metric, qd[0], 3.0).tobytes()


# -- --torch_profile: the server's trace names the card's kernels --------------

def profiled_server_trace(tmp_path, device, n_requests=4):
    """A classifier server (the CLI, in a subprocess) with --torch_profile
    takes `n_requests` raw train requests and is stopped with SIGTERM;
    the exported Chrome trace's events."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys

    import msgpack
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "method": "AROW", "parameter": {"regularization_weight": 1.0},
        "converter": {"string_rules": [{"key": "*", "type": "str",
                                        "sample_weight": "bin",
                                        "global_weight": "bin"}],
                      "hash_max_size": 1 << 12}}))
    out = tmp_path / "prof"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jubatus_tpu_torch.cli.server", "--type",
         "classifier", "--configpath", str(cfg), "--rpc-port", "0",
         "--listen_addr", "127.0.0.1", "--device", device,
         "--torch_profile", str(out)],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("jubatus ready"), proc.stderr.read()
        port = int(line.split()[2].split("=")[1])
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            unp = msgpack.Unpacker(raw=False)
            for i in range(n_requests):
                data = [[f"l{j % 3}", [[[f"k{j}", f"v{i}"]], [], []]]
                        for j in range(16)]
                s.sendall(msgpack.packb([0, i, "train", ["", data]]))
                while True:
                    unp.feed(s.recv(1 << 16))
                    msgs = list(unp)
                    if msgs:
                        assert msgs[0][2] is None, msgs[0]
                        break
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=300) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    (trace,) = out.glob("torch_trace_*.json")
    return json.loads(trace.read_text())["traceEvents"]


def test_torch_profile_trace_names_the_train_scan_kernel(dev, tmp_path):
    events = profiled_server_trace(tmp_path, "cuda")
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("train_scan" in k for k in kernels), sorted(set(kernels))


def test_two_slots_trained_at_once_equal_each_alone_and_drops_free_the_card(
        dev, tmp_path):
    """Two model slots of one cuda server, trained at once from two client
    threads through their own ingest pipelines (the scan kernel on one
    card and stream), end bitwise equal to one-slot servers trained on
    the same requests alone; dropping them returns
    torch.cuda.memory_allocated() to its value before the creates."""
    import gc
    import json
    import threading

    from jubatus_tpu_torch.cli.server import serve
    from jubatus_tpu_torch.rpc.client import Client

    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "method": "AROW", "parameter": {"regularization_weight": 1.0},
        "converter": {"string_rules": [
            {"key": "*", "type": "str", "sample_weight": "bin",
             "global_weight": "bin"}], "num_rules": [
            {"key": "*", "type": "num"}], "hash_max_size": 1 << 16}}))

    def requests(seed):
        rng = np.random.default_rng(seed)
        return [[[f"l{int(rng.integers(8))}",
                  [[["w", f"t{int(t)}"] for t in rng.integers(0, 5000, 6)],
                   [["x", float(rng.random())]], []]] for _ in range(256)]
                for _ in range(16)]

    def start(name):
        return serve(["--type", "classifier", "--configpath", str(cfg),
                      "--rpc-port", "0", "--listen_addr", "127.0.0.1",
                      "--name", name, "--device", "cuda"])

    def train(port, name, reqs):
        with Client("127.0.0.1", port, timeout=120) as c:
            for r in reqs:
                c.call_raw("train", name, r)

    def state(slot):
        slot.dispatcher.flush()
        torch.cuda.synchronize()
        return {k: v.cpu().clone() for k, v in (("w", slot.driver.w),
                                                ("cov", slot.driver.cov))}

    reqs = {"m1": requests(1), "m2": requests(2)}
    alone = {}
    for name in ("m1", "m2"):
        srv, rpc = start(name)
        try:
            train(rpc.port, name, reqs[name])
            alone[name] = state(srv)
        finally:
            rpc.stop()
            srv.stop()
    srv, rpc = start("c")
    try:
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with Client("127.0.0.1", rpc.port, timeout=120) as c:
            for name in ("m1", "m2"):
                assert c.call_raw("create_model", "c", {"name": name})
        threads = [threading.Thread(target=train,
                                    args=(rpc.port, name, reqs[name]))
                   for name in ("m1", "m2")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for name in ("m1", "m2"):
            got = state(srv.slot_for(name))
            for k in ("w", "cov"):
                assert torch.equal(got[k], alone[name][k]), (name, k)
        assert torch.cuda.memory_allocated() > base
        with Client("127.0.0.1", rpc.port, timeout=120) as c:
            for name in ("m1", "m2"):
                assert c.call_raw("drop_model", "c", name) is True
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
    finally:
        rpc.stop()
        srv.stop()


# -- the data-parallel tier: the replica grids and the batched ring ----------

def _grid_inputs(seed, ndp, method, L=8, D=4096, per=96, K=16):
    """ndp diverged replicas and a batch of ndp * per datums whose slices
    share columns with each other (every replica scans the same hazard
    shape)."""
    states, batches = [], []
    for r in range(ndp):
        state, batch = _hazard_inputs(seed * 31 + r, L=L, K=K, B=per, D=D)
        states.append(state)
        batches.append(batch)
    state = [np.stack([s[i] for s in states]) for i in range(4)]
    if method not in ("CW", "AROW", "NHERD"):
        state[1] = np.zeros((ndp, 1, 1), np.float32)
    batch = [np.concatenate([b[i] for b in batches]) for i in range(4)]
    return state, batch


@pytest.mark.parametrize("ndp", [1, 3, 4, 8])
@pytest.mark.parametrize("method", MARGIN)
def test_replica_grid_scan_is_bitwise_one_block_launches(dev, method, ndp):
    """Each replica of ONE grid launch is bitwise a one-block launch on
    its slice, integer state bitwise the plain per-replica loop and the
    tables within the scan's tolerance of it; ndp 1 is the one-block
    launch itself."""
    state, batch = _grid_inputs(MARGIN.index(method), ndp, method)
    grid = [torch.from_numpy(a.copy()).to(dev) for a in state]
    one = [t.clone() for t in grid]
    ref = [t.clone() for t in grid]
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    before = (tc.train_scan_grid.launches, tc.train_scan.launches)
    tc.train_scan_grid(*grid, *bt, method, 0.5)
    assert tc.train_scan_grid.launches == before[0] + 1
    assert tc.train_scan.launches == before[1]
    per = batch[0].shape[0] // ndp
    for r in range(ndp):
        rows = slice(r * per, (r + 1) * per)
        tc.train_scan(one[0][r], one[1][r], one[2][r], one[3][r],
                      *[t[rows] for t in bt], method, 0.5)
    tc.train_scan_grid_ref(*ref, *bt, method, 0.5)
    torch.cuda.synchronize()
    for a, b in zip(grid, one):
        assert torch.equal(a, b)
    assert torch.equal(grid[2], ref[2]) and torch.equal(grid[3], ref[3])
    torch.testing.assert_close(grid[0], ref[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(grid[1], ref[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ndp", [1, 3, 4, 8])
@pytest.mark.parametrize("method", REG)
def test_regression_replica_grid_is_bitwise_one_block_launches(dev, method,
                                                               ndp):
    ws, batches = [], []
    for r in range(ndp):
        w, batch = _reg_inputs(REG.index(method) * 13 + r, "shared", 384)
        ws.append(w)
        batches.append(batch)
    w = np.stack(ws)
    batch = [np.concatenate([b[i] for b in batches]) for i in range(4)]
    grid = torch.from_numpy(w).to(dev)
    one, ref = grid.clone(), grid.clone()
    bt = [torch.from_numpy(a).to(dev) for a in batch]
    before = (tr.train_scan_grid.launches, tr.train_scan.launches)
    tr.train_scan_grid(grid, *bt, method, 0.5, 0.1)
    assert tr.train_scan_grid.launches == before[0] + 1
    assert tr.train_scan.launches == before[1]
    for r in range(ndp):
        rows = slice(r * 384, (r + 1) * 384)
        tr.train_scan(one[r], *[t[rows] for t in bt], method, 0.5, 0.1)
    tr.train_scan_grid_ref(ref, *bt, method, 0.5, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(grid, one)
    torch.testing.assert_close(grid, ref, rtol=RTOL, atol=ATOL)


def test_replica_grids_refuse_what_they_do_not_take(dev):
    w = torch.zeros((3, 8, 64), device=dev)
    cov = torch.ones((3, 8, 64), device=dev)
    counts = torch.zeros((3, 8), dtype=torch.int32, device=dev)
    active = torch.zeros((3, 8), dtype=torch.bool, device=dev)
    idx = torch.zeros((8, 16), dtype=torch.int32, device=dev)   # 8 % 3
    val = torch.zeros((8, 16), device=dev)
    lab = torch.zeros(8, dtype=torch.int32, device=dev)
    mask = torch.ones(8, device=dev)
    before = tc.train_scan_grid.launches
    with pytest.raises(ValueError, match="do not split"):
        tc.train_scan_grid(w, cov, counts, active, idx, val, lab, mask,
                           "AROW", 1.0)
    with pytest.raises(ValueError, match="want w"):
        tc.train_scan_grid(w[0], cov, counts, active, idx[:6], val[:6],
                           lab[:6], mask[:6], "AROW", 1.0)
    with pytest.raises(ValueError, match="do not split"):
        tr.train_scan_grid(torch.zeros((3, 64), device=dev), idx, val,
                           mask, mask, "PA", 1.0, 0.1)
    assert tc.train_scan_grid.launches == before


@pytest.mark.parametrize("n,shape", [(2, (3, 5000)), (3, (7, 4099)),
                                     (4, (1,)), (5, (33, 1000)),
                                     (8, (32, 1 << 14))])
def test_batched_ring_is_bitwise_the_plain_ring(dev, n, shape):
    """The ring on the card (one quantize and one dequantize launch over
    all ranks a hop) against the same ring on the plain quantizer pair on
    the card: bitwise, n quantize and 2n - 1 dequantize launches."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.standard_normal((n,) + shape) * np.exp(
        rng.uniform(-3, 3, (n,) + shape))).astype(np.float32)).to(dev)
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    got = tq.ring_all_reduce_int8(x, min_elems=0)
    assert (tq.quantize_int8.launches - before[0],
            tq.dequantize_int8.launches - before[1]) == (n, 2 * n - 1)
    want = ring_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for r in range(1, n):
        assert torch.equal(got[r], got[0])


def ring_plain(x):
    """ring_all_reduce_int8 with the quantizer pair's plain versions (the
    written arithmetic), on x's device."""
    from unittest import mock
    with mock.patch.object(tq, "quantize_int8", tq._quantize_ref), \
            mock.patch.object(tq, "dequantize_int8", tq._dequantize_ref):
        return tq.ring_all_reduce_int8(x, min_elems=0)


# ---------------------------------------------------------------------------
# the sharded nearest_neighbor (parallel/sharded.py): K3 and K6 once a
# shard, each bitwise its plain version on the same slab, and the merge
# ---------------------------------------------------------------------------

from jubatus_tpu_torch.parallel import sharded as tsh  # noqa: E402
from jubatus_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _sharded_pair(dev, method, nshard, n=600):
    cfg = {"method": method, "parameter": {"hash_num": 64},
           "converter": {"num_rules": [{"key": "*", "type": "num"}],
                         "hash_max_size": 4096},
           "index": {"min_rows": 0}}
    drivers = [tsh.ShardedNearestNeighborDriver(
        cfg, make_mesh(shard=nshard, device=d)) for d in (dev, "cpu")]
    rng = np.random.default_rng(nshard)
    centers = rng.standard_normal((20, 16))
    data = [Datum([], [(f"f{j}", float(x)) for j, x in enumerate(
        centers[i % 20] + 0.05 * rng.standard_normal(16))])
        for i in range(n + 10)]
    for d in drivers:
        d.configure_index("lsh_probe", probes=4)
        d.set_row_many([(f"r{i}", x) for i, x in enumerate(data[:n])])
    return drivers, data[n:]


@pytest.mark.parametrize("method", ["lsh", "minhash", "euclid_lsh"])
@pytest.mark.parametrize("nshard", [2, 4])
def test_sharded_sweep_and_probe_are_bitwise_the_plain_per_shard(
        dev, method, nshard):
    (card, cpu), queries = _sharded_pair(dev, method, nshard)
    assert card.pack() == cpu.pack()
    q_sigs, qnorms = card._datum_query(queries[0])
    s, c = card.nshard, card.capacity
    kb = tsh._k_bucket(10, c)
    before = tl.sig_topk.launches
    vals, rows = tsh.shard_topk(method, card.sig, card.norms, card.valid,
                                q_sigs, qnorms, 64, kb)
    assert tl.sig_topk.launches == before + s
    want = torch.cat([tl.sig_topk_ref(
        method, card.sig[i], card.norms[i], c, q_sigs, qnorms, 64, kb,
        card.valid[i]) for i in range(s)])
    wr, wv = tl.keys_to_host(want)
    assert np.array_equal(rows, wr) and np.array_equal(vals, wv)
    card._index_for_query()
    csr = card.index.device_csr(squeeze=False)
    kb = tsh._k_bucket(10 * (len(card.index.plan) + 1),
                       len(card.index.plan) * csr[4] + csr[3].shape[1])
    before = tcand.sig_probe.launches
    pv, pr, pn = tsh.shard_probe(method, card.sig, card.norms, card.valid,
                                 csr, card.index.plan, card.index.bits,
                                 q_sigs, qnorms, 64, kb)
    assert tcand.sig_probe.launches == before + s
    want = torch.cat([tcand.sig_probe_ref(
        method, card.sig[i], card.norms[i], c, card.valid[i], q_sigs,
        qnorms, csr[0][i], csr[1][i], csr[2][i], csr[3][i], csr[4],
        card.index.plan, card.index.bits, 64, kb) for i in range(s)])
    wr, wv, wn = tcand.probe_result(want, kb)
    assert np.array_equal(pr, wr) and np.array_equal(pv, wv) \
        and np.array_equal(pn, wn)
    assert tsh.merge_candidates(pv, pr, card.shard_row_ids, 10,
                                dedupe=True) == \
        tsh.merge_candidates(wv, wr, card.shard_row_ids, 10, dedupe=True)


@pytest.mark.parametrize("method", ["lsh", "euclid_lsh"])
def test_sharded_driver_on_the_card_matches_the_cpu(dev, method):
    (card, cpu), queries = _sharded_pair(dev, method, 4)
    for q in queries:
        before = (tl.sig_topk.launches, tcand.sig_probe.launches)
        a = card.similar_row_from_datum(q, 10)
        launched = (tl.sig_topk.launches - before[0],
                    tcand.sig_probe.launches - before[1])
        assert launched in ((0, 4), (4, 4))     # probed, or fell back
        assert a == cpu.similar_row_from_datum(q, 10)
    saved = card.index
    card.index = cpu.index = None
    try:
        before = tl.sig_topk.launches
        a = card.neighbor_row_from_id("r7", 20)
        assert tl.sig_topk.launches == before + 4
        assert a == cpu.neighbor_row_from_id("r7", 20)
    finally:
        card.index = saved
