"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need an NVIDIA card and nvcc (a CUDA kernel has no CPU
mode), carry the `cuda` marker and skip elsewhere.  On a machine with a
card, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the suite's conftest sets up JAX, which that machine need
not have; this file imports nothing of it.)  Tolerances: the quantizer
pair is bitwise; the scan kernel sums in another order than the plain
version, so its tables agree within rtol 1e-5 / atol 1e-6 and its integer
state bitwise.
"""

import numpy as np
import pytest
import torch

from jubatus_tpu_torch.fv import Datum
from jubatus_tpu_torch.mix import codec
from jubatus_tpu_torch.mix.linear_mixer import encode_wire_diff
from jubatus_tpu_torch.models import classifier as tc
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


@pytest.mark.parametrize("shape", [(32, 512), (96, 1536), (4096, 512)])
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
