"""The port's blockwise int8 quantizer (jubatus_tpu_torch/parallel/
quantized.py) against the JAX package's Pallas kernels and host codec.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as tests/test_quantized.py runs them.
Every comparison is bitwise: the wire bytes of the v3 MIX codec depend on
it.  The CUDA kernels themselves are held against the same plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.parallel import quantized as jq
from jubatus_tpu_torch.parallel import quantized as tq

# the suite's files run side by side in worker processes: one intra-op
# thread keeps these small tensors from contending for the cores
torch.set_num_threads(1)


def _mixed(rng, shape):
    """Values spread over seven decades, so tiles get very different
    scales."""
    x = rng.standard_normal(shape).astype(np.float32)
    return x * rng.choice(np.array([1e-4, 1e-2, 1.0, 1e3], np.float32),
                          size=shape)


def _ties() -> np.ndarray:
    """One tile whose absmax is 127, so scale == 1.0 exactly and every
    value k + 0.5 sits on a rounding tie."""
    x = np.zeros((32, 512), np.float32)
    x[0, 0] = 127.0
    x[1, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return x


def _cases():
    rng = np.random.default_rng(11)
    zero_tile = _mixed(rng, (64, 1024))
    zero_tile[32:, :512] = 0.0
    return {
        "one_tile": _mixed(rng, (32, 512)),
        "grid_3x3": _mixed(rng, (96, 1536)),
        "zero_tile": zero_tile,
        "all_zero": np.zeros((32, 512), np.float32),
        "ties": _ties(),
    }


CASES = _cases()


def _assert_matches_jax(x, qt, st, qj, sj):
    """The port's scale is the true f32 quotient absmax / 127, as numpy's
    host codec computes it.  XLA compiles the JAX kernel's division by
    the constant 127 into a multiply by fl(1/127), which lands one ulp
    away in a few tiles.  Where the two scales agree, the int8 tiles agree
    bitwise; where they do not, a value can move by one step."""
    qt, st = qt.numpy(), st.numpy()
    qj, sj = np.asarray(qj), np.asarray(sj)
    r, c = x.shape
    absmax = np.abs(x.reshape(r // 32, 32, c // 512, 512)).max(axis=(1, 3))
    floor = np.maximum(absmax, np.float32(1e-30))
    np.testing.assert_array_equal(st, floor / np.float32(127))
    np.testing.assert_array_equal(sj, floor * (np.float32(1) /
                                               np.float32(127)))
    same = np.repeat(np.repeat(st == sj, 32, 0), 512, 1)
    np.testing.assert_array_equal(qt[same], qj[same])
    assert np.abs(qt.astype(int) - qj.astype(int)).max(initial=0) <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_matches_pallas_kernel(case):
    x = CASES[case]
    qj, sj = jq.quantize_int8(jnp.asarray(x))       # Pallas, interpret mode
    qt, st = tq.quantize_int8(torch.from_numpy(x))  # plain version on CPU
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    _assert_matches_jax(x, qt, st, qj, sj)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dequantize_matches_pallas_kernel(case):
    qj, sj = jq.quantize_int8(jnp.asarray(CASES[case]))
    back_j = np.asarray(jq.dequantize_int8(qj, sj))
    back_t = tq.dequantize_int8(torch.from_numpy(np.asarray(qj)),
                                torch.from_numpy(np.asarray(sj)))
    np.testing.assert_array_equal(back_t.numpy(), back_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_jnp_reference(case):
    """Run op by op (not under jit), the JAX package's jnp reference
    divides by 127 exactly and agrees with the port bitwise."""
    x = CASES[case]
    qj, sj = jq._quantize_ref(jnp.asarray(x))
    qt, st = tq._quantize_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tq._dequantize_ref(torch.from_numpy(np.asarray(qj)),
                           torch.from_numpy(np.asarray(sj))).numpy(),
        np.asarray(jq._dequantize_ref(qj, sj)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_match_jax_host_codec_bitwise(case):
    """The host codec's contiguous 16384-element blocks of the row-major
    array are exactly the tiles when the array is [R, 512]."""
    x = CASES[case]
    x512 = np.ascontiguousarray(x.reshape(-1, 512)) if x.shape[1] == 512 \
        else np.ascontiguousarray(
            x.reshape(x.shape[0] // 32, 32, -1, 512).transpose(0, 2, 1, 3)
            .reshape(-1, 512))
    qn, sn = jq.quantize_blockwise_np(x512)
    qt, st = tq.quantize_int8(torch.from_numpy(x512))
    np.testing.assert_array_equal(qt.numpy().reshape(-1), qn)
    np.testing.assert_array_equal(st.numpy().reshape(-1), sn)


def test_ties_round_half_even():
    q, s = tq.quantize_int8(torch.from_numpy(_ties()))
    assert float(s[0, 0]) == 1.0
    assert q[1, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


def test_zero_tile_scale_is_floor_over_127():
    _, s = tq.quantize_int8(torch.zeros((32, 512)))
    assert s.numpy()[0, 0] == np.float32(np.float32(1e-30) / np.float32(127))


# -- blockwise (wire) form ---------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (16384,), (3, 5461), (2, 16385),
                                   (32, 1100), (5, 3, 4099)])
def test_blockwise_matches_jax_host_codec(shape):
    """Sizes below, at and just past a 16384-element block, so the last
    block is partial in most cases: its zero padding never reaches the
    wire and cannot move the block's absmax."""
    rng = np.random.default_rng(sum(shape))
    x = _mixed(rng, shape)
    qn, sn = jq.quantize_blockwise_np(x)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x))
    assert qt.numel() == x.size
    np.testing.assert_array_equal(qt.numpy(), qn)
    np.testing.assert_array_equal(st.numpy(), sn)
    back = tq.dequantize_blockwise(qt, st, shape).numpy()
    np.testing.assert_array_equal(back, jq.dequantize_blockwise_np(qn, sn,
                                                                   shape))


@pytest.mark.parametrize("shape", [(0,), (4, 3000), (40000,)])
def test_numpy_copies_match_jax_host_codec(shape):
    x = _mixed(np.random.default_rng(5), shape)
    qa, sa = tq.quantize_blockwise_np(x)
    qb, sb = jq.quantize_blockwise_np(x)
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(tq.dequantize_blockwise_np(qa, sa, shape),
                                  jq.dequantize_blockwise_np(qb, sb, shape))


def test_blockwise_empty():
    q, s = tq.quantize_blockwise(torch.zeros((0, 4)))
    assert q.numel() == 0 and s.numel() == 0
    assert tuple(tq.dequantize_blockwise(q, s, (0, 4)).shape) == (0, 4)


def test_blockwise_is_the_tile_view():
    """Contiguous 16384-element blocks of a flat array are the 32x512
    tiles of its row-major [R, 512] view."""
    x = _mixed(np.random.default_rng(9), (64, 512))
    qb, sb = tq.quantize_blockwise(torch.from_numpy(x))
    qt, st = tq.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qb.numpy(), qt.numpy().reshape(-1))
    np.testing.assert_array_equal(sb.numpy(), st.numpy().reshape(-1))


@pytest.mark.parametrize("n", [1, 15, 16383, 16384, 16385, 32 * 40883])
def test_blockwise_tails_match_jax_host_codec(n):
    """Runs that end anywhere in a block, up to the MIX round's diff
    tensor (32 labels x 40883 columns)."""
    x = _mixed(np.random.default_rng(n), (n,))
    qn, sn = jq.quantize_blockwise_np(x)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), qn)
    np.testing.assert_array_equal(st.numpy(), sn)
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(qt, st, (n,)).numpy(),
        jq.dequantize_blockwise_np(qn, sn, (n,)))


def _assert_same_scales(got, want):
    """NaN at the same blocks, every other scale bitwise equal."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_nan_tile_gets_a_nan_scale_like_the_host_codec():
    x = _mixed(np.random.default_rng(4), (32, 512))
    x[7, 300] = np.nan
    _, sn = jq.quantize_blockwise_np(x)
    assert np.isnan(sn).tolist() == [True]
    _assert_same_scales(tq._quantize_ref(torch.from_numpy(x))[1], sn)
    _assert_same_scales(tq.quantize_int8(torch.from_numpy(x))[1], sn)


def test_nan_block_of_a_run_gets_a_nan_scale_like_the_host_codec():
    """Only the block holding the NaN changes: the other blocks' scales
    and int8 values stay bitwise the host codec's (the int8 values of the
    NaN block are not compared: casting NaN to int8 is undefined)."""
    n = 3 * 16384 + 100
    x = _mixed(np.random.default_rng(6), (n,))
    x[16384 + 5] = np.nan
    qn, sn = jq.quantize_blockwise_np(x)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x))
    assert np.isnan(sn).tolist() == [False, True, False, False]
    _assert_same_scales(st, sn)
    keep = np.ones(n, bool)
    keep[16384:2 * 16384] = False
    np.testing.assert_array_equal(qt.numpy()[keep], qn[keep])


def test_unaligned_views_are_refused_before_a_launch():
    tq._check_aligned(torch.zeros(16), "x")
    with pytest.raises(ValueError, match="16-byte"):
        tq._check_aligned(torch.zeros(17)[1:], "x")


# -- wrapper contract ---------------------------------------------------------

@pytest.mark.parametrize("bad", [
    torch.zeros((32, 500)),                      # not whole tiles
    torch.zeros((30, 512)),
    torch.zeros((32, 512), dtype=torch.float64),  # wrong type
    torch.zeros((32, 1024))[:, ::2],             # not contiguous
])
def test_quantize_rejects_what_the_kernel_cannot_take(bad):
    with pytest.raises(ValueError):
        tq.quantize_int8(bad)


def test_dequantize_rejects_mismatched_scales():
    q = torch.zeros((64, 512), dtype=torch.int8)
    with pytest.raises(ValueError):
        tq.dequantize_int8(q, torch.ones((1, 1)))


def test_wrappers_refuse_other_devices_and_count_only_launches():
    """Off the CPU a wrapper launches its kernel or raises; the plain
    version serves CPU tensors only and is no launch."""
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    with pytest.raises(ValueError):
        tq.quantize_int8(torch.zeros((32, 512), device="meta"))
    q, s = tq.quantize_int8(torch.ones((32, 512)))
    tq.dequantize_int8(q, s)
    assert (tq.quantize_int8.launches,
            tq.dequantize_int8.launches) == before
