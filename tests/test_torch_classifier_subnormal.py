"""The classifier's opt-in "parallel" microbatch mode and its centroid
methods (cosine, euclidean) on the subnormal repro datums [3e-20, 3e-20]
and [1e-39, 1.0], against the JAX package bit for bit: they flush
float32 subnormals as XLA does, as the sequential scans do
(tests/test_torch_classifier.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jubatus_tpu.models import classifier as jc
from jubatus_tpu_torch.models import classifier as tc
from tests.test_torch_classifier import CENTROID, MARGIN, SUBNORMAL, run_both


@pytest.mark.parametrize("w0", (0.0, 0.5))
@pytest.mark.parametrize("vals", sorted(SUBNORMAL))
@pytest.mark.parametrize("method", MARGIN)
def test_subnormal_datums_in_parallel_mode_match_jax_bitwise(method, vals,
                                                             w0):
    """The opt-in "parallel" microbatch mode flushes as XLA does: before
    the flush, |x|^2 of [3e-20, 3e-20] stayed 9e-40 here and every method
    moved w (PA by 1.5e-8), and 1e-39 was written to w."""
    state = (np.full((2, 8), w0, np.float32), np.ones((2, 8), np.float32),
             np.zeros(2, np.int32), np.array([False, True]))
    batch = (np.array([[1, 2, 0, 0]], np.int32),
             np.array([SUBNORMAL[vals] + [0.0, 0.0]], np.float32),
             np.zeros(1, np.int32), np.ones(1, np.float32))
    out_j, out_t = run_both(jc.train_parallel_impl, tc.train_parallel, state,
                            batch, method, 1.0)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(np.ascontiguousarray(b).view(np.uint8),
                                      np.ascontiguousarray(a).view(np.uint8))


@pytest.mark.parametrize("vals", sorted(SUBNORMAL))
@pytest.mark.parametrize("kind", CENTROID)
def test_subnormal_datums_in_centroid_methods_match_jax_bitwise(kind, vals):
    """cosine/euclidean: the centroid sums read 1e-39 as 0, and the scores
    of both repro datums are XLA's bit for bit."""
    sums = np.zeros((2, 8), np.float32)
    counts, active = np.zeros(2, np.int32), np.zeros(2, bool)
    idx = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    val = np.array([SUBNORMAL[vals] + [0, 0], [0.5, 0.25, 0, 0]], np.float32)
    lab, mask = np.array([0, 1], np.int32), np.ones(2, np.float32)
    out_j = jc._centroid_train(*(jnp.asarray(a) for a in (
        sums, counts, active, idx, val, lab, mask)))
    out_t = [torch.from_numpy(a.copy()) for a in (sums, counts, active)]
    tc._centroid_train(*out_t, *(torch.from_numpy(a)
                                 for a in (idx, val, lab, mask)))
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(
            b.numpy().view(np.uint8), np.ascontiguousarray(a).view(np.uint8))
    q_val = np.array([v + [0, 0] for v in SUBNORMAL.values()], np.float32)
    q_idx = np.array([[1, 2, 0, 0]] * len(q_val), np.int32)
    want = np.asarray(jc._centroid_scores(*out_j, jnp.asarray(q_idx),
                                          jnp.asarray(q_val), kind))
    got = tc._centroid_scores(*out_t, torch.from_numpy(q_idx),
                              torch.from_numpy(q_val), kind).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
