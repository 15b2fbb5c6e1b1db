"""Port parity: the brute-force matcher.

The same numpy descriptors and masks go to both packages, which must return
identical matches (indices and masks) and scores within 1e-5 (float32 GEMM
in another summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sara_tpu.core.types import Keypoints as JaxKeypoints
from sara_tpu.matching import brute_force as jbf
from sara_tpu_torch.convert import keypoints_from_numpy
from sara_tpu_torch.matching import brute_force as tbf


def _keypoints(rs, n, valid, base=None, noise=0.0):
    d = rs.rand(n, 128).astype(np.float32) if base is None else \
        base + noise * rs.randn(*base.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    z = np.zeros(n, np.float32)
    return (rs.rand(n, 2).astype(np.float32), z, z, z, d, mask)


@pytest.mark.parametrize("ratio,mutual", [(0.8, True), (0.8, False),
                                          (0.95, True)])
def test_match_descriptors(ratio, mutual):
    rs = np.random.RandomState(0)
    a = _keypoints(rs, 300, 260)
    # b: a noisy permuted copy of a, so that many rows have a true match.
    perm = rs.permutation(300)
    b = _keypoints(rs, 300, 280, base=a[4][perm], noise=0.02)
    mj = jbf.match_descriptors(JaxKeypoints(*(jnp.asarray(f) for f in a)),
                               JaxKeypoints(*(jnp.asarray(f) for f in b)),
                               jbf.MatchParams(ratio=ratio, mutual=mutual))
    mt = tbf.match_descriptors(keypoints_from_numpy(a, "cpu"),
                               keypoints_from_numpy(b, "cpu"),
                               tbf.MatchParams(ratio=ratio, mutual=mutual),
                               device="cpu")
    mask = np.asarray(mj.mask)
    assert mask.sum() > 50
    np.testing.assert_array_equal(mask, mt.mask.numpy())
    np.testing.assert_array_equal(np.asarray(mj.i), mt.i.numpy())
    np.testing.assert_array_equal(np.asarray(mj.j)[mask], mt.j.numpy()[mask])
    np.testing.assert_allclose(np.asarray(mj.score)[mask],
                               mt.score.numpy()[mask], atol=1e-5, rtol=0)


def test_pairwise_sqdist_and_top2():
    rs = np.random.RandomState(1)
    da = rs.rand(40, 128).astype(np.float32)
    db = rs.rand(50, 128).astype(np.float32)
    dj = jbf._pairwise_sqdist(jnp.asarray(da), jnp.asarray(db))
    dt = tbf._pairwise_sqdist(torch.from_numpy(da), torch.from_numpy(db))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4,
                               rtol=1e-6)
    for a, b in zip(jbf._top2_min(dj), tbf._top2_min(torch.from_numpy(
            np.array(dj)))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_match_descriptors_needs_a_device():
    rs = np.random.RandomState(2)
    a = keypoints_from_numpy(_keypoints(rs, 8, 8), "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbf.match_descriptors(a, a)
