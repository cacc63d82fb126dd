"""utils/pose_utils.py (host numpy) against the JAX package's twin: equal
bit for bit on the same inputs, every output of estimate_camera,
align_3d_to_2d and procrustes (with and without scaling, each reflection
rule, a 2-D Y padded to 3-D)."""

from __future__ import annotations

import numpy as np
import pytest

from posetpu.utils import pose_utils as jpu
from posetpu_torch.utils import pose_utils as tpu


def _poses(rng):
    x3 = rng.randn(17, 3) * 300.0
    r, _ = np.linalg.qr(rng.randn(3, 3))
    x2 = 1.7 * (x3 @ r.T)[:, :2] + np.array([500.0, 400.0]) + rng.randn(17, 2)
    return x3, x2


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_estimate_camera_and_align_equal_jax(rng):
    x3, x2 = _poses(rng)
    _equal(tpu.estimate_camera(x3, x2), jpu.estimate_camera(x3, x2))
    _equal(tpu.align_3d_to_2d(x3, x2), jpu.align_3d_to_2d(x3, x2))
    r, _, s = tpu.estimate_camera(x3, x2)
    np.testing.assert_allclose(r @ r.T, np.eye(2), atol=1e-12)
    assert 1.5 < s < 1.9


@pytest.mark.parametrize("scaling", [True, False])
@pytest.mark.parametrize("reflection", ["best", True, False])
@pytest.mark.parametrize("dims", [3, 2])
def test_procrustes_equals_jax(rng, scaling, reflection, dims):
    x = rng.randn(17, 3)
    y = (x @ np.linalg.qr(rng.randn(3, 3))[0])[:, :dims] * 2.0 + 0.1 * rng.randn(17, dims)
    got = tpu.procrustes(x.copy(), y.copy(), scaling=scaling, reflection=reflection)
    ref = jpu.procrustes(x.copy(), y.copy(), scaling=scaling, reflection=reflection)
    _equal(got, ref)
    assert np.isfinite(got[0])
