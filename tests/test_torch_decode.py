"""posetpu_torch's heatmap decode (B7's plain version) against the JAX
package's ``decode_heatmaps`` and the Pallas kernel in interpret mode, on
the same numpy maps, including equal maxima (the first row-major index
wins), non-positive maps (coords zeroed) and peaks on the border (no nudge).
Integers, comparisons and +-0.25: equal exactly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.core import inference as jinf  # noqa: E402
from posetpu.ops import heatmap as jhm  # noqa: E402
from posetpu.ops.pallas.decode import decode_heatmaps_pallas  # noqa: E402
from posetpu_torch.core import inference as tinf  # noqa: E402
from posetpu_torch.ops import heatmap as thm  # noqa: E402
from posetpu_torch.ops.decode import decode_heatmaps_kernel, split_decoded  # noqa: E402

H, W = 16, 16


def _maps(rng):
    """[3, 8, H, W]: random maps, then hand-made hard cases in batch 0."""
    x = rng.randn(3, 8, H, W).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 0, 5, 7] = x[0, 0, 5, 9] = x[0, 0, 9, 2] = 3.0   # ties: first wins
    x[0, 1] = -np.abs(x[0, 1]) - 0.1                     # all negative
    x[0, 2] = 0.0                                        # max == 0
    for k, (yy, xx) in enumerate([(0, 0), (0, 9), (H - 1, W - 1), (7, 1), (7, W - 2),
                                  (1, 8)]):              # border and near-border peaks
        x[1, k, yy, xx] = 9.0
    x[2, 0] = 0.5                                        # constant positive map
    x[2, 1, 6, 6], x[2, 1, 6, 7], x[2, 1, 6, 5] = 5.0, 1.0, 1.0  # equal neighbours
    return x


def test_decode_matches_jax_and_pallas(rng):
    x = _maps(rng)
    ref_c, ref_m = jhm.decode_heatmaps(jnp.asarray(x))
    pal_c, pal_m = decode_heatmaps_pallas(jnp.asarray(x), tile=8, interpret=True)
    for fn in (thm.decode_heatmaps, decode_heatmaps_kernel):  # CPU: the plain version
        got_c, got_m = fn(torch.from_numpy(x))
        assert tuple(got_c.shape) == (3, 8, 2) and tuple(got_m.shape) == (3, 8)
        for rc, rm in ((ref_c, ref_m), (pal_c, pal_m)):
            np.testing.assert_array_equal(got_c.numpy(), np.asarray(rc))
            np.testing.assert_array_equal(got_m.numpy(), np.asarray(rm))
    got_c = got_c.numpy()
    assert tuple(got_c[0, 0]) == (7.0, 5.0)       # tie -> (x=7, y=5); flat neighbours
    assert (got_c[0, 1] == 0).all() and (got_c[0, 2] == 0).all()
    assert tuple(got_c[1, 2]) == (W - 1, H - 1)   # border peak: no nudge
    assert tuple(got_c[2, 1]) == (6.0, 6.25 if x[2, 1, 7, 6] > x[2, 1, 5, 6] else 5.75)


@pytest.mark.parametrize("post", [True, False])
def test_max_preds_and_post_process_flag(rng, post):
    x = _maps(rng)
    ref_c, ref_m = jhm.decode_heatmaps(jnp.asarray(x), post_process=post)
    got_c, got_m = decode_heatmaps_kernel(torch.from_numpy(x), post_process=post)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    if not post:
        mp_c, mp_m = thm.max_preds(torch.from_numpy(x))
        jc, jm = jhm.max_preds(jnp.asarray(x))
        np.testing.assert_array_equal(mp_c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(mp_m.numpy(), np.asarray(jm))


def test_decode_non_square_and_leading_shapes(rng):
    x = rng.randn(5, 12, 20).astype(np.float32)
    ref_c, ref_m = jhm.decode_heatmaps(jnp.asarray(x))
    got_c, got_m = decode_heatmaps_kernel(torch.from_numpy(x))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    one_c, one_m = decode_heatmaps_kernel(torch.from_numpy(x[0]))
    assert tuple(one_c.shape) == (2,) and one_m.dim() == 0
    with pytest.raises(ValueError):
        decode_heatmaps_kernel(torch.zeros(7))


def test_flip_back_and_shift_match_jax(rng):
    x = rng.randn(2, 16, H, W).astype(np.float32)
    pairs = [(0, 5), (1, 4), (2, 3)]
    np.testing.assert_array_equal(
        thm.flip_back(torch.from_numpy(x), pairs).numpy(),
        np.asarray(jhm.flip_back(jnp.asarray(x), pairs)))
    np.testing.assert_array_equal(
        thm.shift_heatmap_right(torch.from_numpy(x)).numpy(),
        np.asarray(jhm.shift_heatmap_right(jnp.asarray(x))))


def test_final_preds_matches_jax(rng):
    """[N, V, J, h, w] in the port, [N, V, h, w, J] in the JAX package.
    maxvals exact; preds within atol 1e-4 (the inverse affine's small
    matmul rounds differently in the two frameworks). Every map here has a
    positive maximum: on a non-positive map the JAX ``final_preds`` decodes
    with its channels-last twin, which nudges the zeroed coords, where the
    port decodes as ``decode_heatmaps`` and the reference's
    ``get_final_preds`` do (no nudge at the zeroed (0, 0))."""
    x = _maps(rng)[:, None].repeat(4, axis=1)  # [3, 4, 8, H, W]
    x = x + 0.01 * rng.randn(*x.shape).astype(np.float32)
    x[0, :, 1:3] += 4.0  # lift the two non-positive maps
    assert (x.max(axis=(-1, -2)) > 0).all()
    center = (100 + 50 * rng.rand(3, 4, 2)).astype(np.float32)
    scale = (1 + rng.rand(3, 4, 2)).astype(np.float32)
    got_p, got_m = tinf.final_preds(torch.from_numpy(x), torch.from_numpy(center),
                                    torch.from_numpy(scale))
    ref_p, ref_m = jinf.final_preds(jnp.asarray(np.moveaxis(x, -3, -1)),
                                    jnp.asarray(center), jnp.asarray(scale))
    assert tuple(got_p.shape) == (3, 4, 8, 2)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=1e-4)


@pytest.mark.parametrize("lead", [(), (3,), (2, 4, 16)])
def test_decode_wrapper_shapes_dtypes_values(rng, lead):
    """The wrapper's two results for any leading shape: coords [..., 2] and
    maxvals [...] f32, equal to the JAX decode's."""
    x = rng.randn(*lead, H, W).astype(np.float32)
    x.reshape(-1, H, W)[0, 4, 5] = 7.0
    coords, maxvals = decode_heatmaps_kernel(torch.from_numpy(x))
    ref_c, ref_m = jhm.decode_heatmaps(jnp.asarray(x))
    assert coords.shape == lead + (2,) and maxvals.shape == lead
    assert coords.dtype == maxvals.dtype == torch.float32
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("lead", [(), (3,), (2, 4, 16)])
def test_split_decoded_views_outlive_each_other(rng, lead):
    """The kernel's one [..., 3] output (x, y, max) comes back as two views:
    today's shapes, dtypes and values, each usable after the other (and the
    output's own name) is dropped."""
    import gc

    rows = rng.randn(*lead, 3).astype(np.float32)
    out = torch.from_numpy(rows.copy())
    coords, maxvals = split_decoded(out)
    assert coords.shape == lead + (2,) and maxvals.shape == lead
    assert coords.dtype == maxvals.dtype == torch.float32
    assert coords.untyped_storage().data_ptr() == maxvals.untyped_storage().data_ptr()
    del out, maxvals
    gc.collect()
    np.testing.assert_array_equal(coords.numpy(), rows[..., :2])
    assert (coords + 1.0).shape == lead + (2,)        # usable in further ops
    coords, maxvals = split_decoded(torch.from_numpy(rows.copy()))
    del coords
    gc.collect()
    np.testing.assert_array_equal(maxvals.numpy(), rows[..., 2])
    np.testing.assert_array_equal((maxvals > 0.0).float().numpy(),
                                  (rows[..., 2] > 0).astype(np.float32))
