"""The port's flip-test pieces against the JAX package on the same numpy
inputs: the packed-input mirror, the packed un-flip and right-shift at both
packing depths, and the packed merge. All are index moves and one average:
equal exactly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from posetpu.core import inference as jinf  # noqa: E402
from posetpu.data.base import union_flip_pairs as jax_pairs  # noqa: E402
from posetpu.models.quant import mirror_s2d_hwcn as jax_mirror  # noqa: E402
from posetpu.ops import heatmap as jhm  # noqa: E402
from posetpu_torch.core import inference as tinf  # noqa: E402
from posetpu_torch.data.base import union_flip_pairs  # noqa: E402
from posetpu_torch.models.quant import mirror_s2d_hwcn  # noqa: E402
from posetpu_torch.ops import heatmap as thm  # noqa: E402
from posetpu_torch.serving import pack_hwcn  # noqa: E402

H, W = 8, 12


def test_mirror_s2d_hwcn_matches_jax_and_the_flipped_images(rng):
    images = rng.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    packed = pack_hwcn(torch.from_numpy(images))
    got = mirror_s2d_hwcn(packed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mirror(packed.numpy())))
    # the mirror of the packed batch is the packed W-reversed batch
    flipped = pack_hwcn(torch.from_numpy(images[:, :, ::-1].copy()))
    assert torch.equal(got, flipped)


def test_union_flip_pairs_match_jax():
    assert [tuple(p) for p in union_flip_pairs()] == [tuple(p) for p in jax_pairs()]


@pytest.mark.parametrize("levels", [1, 2])
def test_flip_back_packed_matches_jax(rng, levels):
    x = rng.randn(16, 2, 3, H * W).astype(np.float32)
    pairs = union_flip_pairs()
    got = thm.flip_back_packed(torch.from_numpy(x), pairs, (H, W), levels=levels)
    ref = jhm.flip_back_packed(jnp.asarray(x), pairs, (H, W), levels=levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and it is the row-major un-flip seen through the packing tables
    t = thm.phase_index_tables((H, W), levels=levels)
    rowmajor = torch.from_numpy(x)[..., torch.as_tensor(t["packed"], dtype=torch.int64)]
    back = thm.flip_back(rowmajor.reshape(16, 2, 3, H, W).movedim(0, 2), pairs)
    back = back.movedim(2, 0).reshape(16, 2, 3, H * W)
    assert torch.equal(got[..., torch.as_tensor(t["packed"], dtype=torch.int64)], back)


@pytest.mark.parametrize("levels", [1, 2])
def test_shift_heatmap_right_packed_matches_jax(rng, levels):
    x = rng.randn(4, 5, H * W).astype(np.float32)
    got = thm.shift_heatmap_right_packed(torch.from_numpy(x), (H, W), levels=levels)
    ref = jhm.shift_heatmap_right_packed(jnp.asarray(x), (H, W), levels=levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("levels,shift", [(1, False), (1, True), (2, False), (2, True)])
def test_flip_test_merge_packed_matches_jax(rng, levels, shift):
    a = rng.randn(16, 4, H * W).astype(np.float32)
    b = rng.randn(16, 4, H * W).astype(np.float32)
    pairs = union_flip_pairs()
    got = tinf.flip_test_merge_packed(torch.from_numpy(a), torch.from_numpy(b), pairs,
                                      (H, W), shift=shift, levels=levels)
    ref = jinf.flip_test_merge_packed(jnp.asarray(a), jnp.asarray(b), pairs, (H, W),
                                      shift=shift, levels=levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shift", [False, True])
def test_flip_test_merge_matches_jax(rng, shift):
    """The float path's merge: the port takes [..., J, h, w], the JAX
    function [..., h, w, J] (transposed here). Exact."""
    a = rng.randn(2, 4, 16, H, W).astype(np.float32)
    b = rng.randn(2, 4, 16, H, W).astype(np.float32)
    pairs = union_flip_pairs()
    got = tinf.flip_test_merge(torch.from_numpy(a), torch.from_numpy(b), pairs, shift=shift)
    hwj = lambda t: jnp.asarray(np.moveaxis(t, -3, -1))
    ref = jinf.flip_test_merge(hwj(a), hwj(b), pairs, shift=shift)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(np.asarray(ref), -1, -3))


def test_fuse_routing_matches_jax(rng):
    """Within 1 ulp of each term: XLA may contract the lerp into FMAs."""
    raw = rng.randn(3, 4, 16, H, W).astype(np.float32)
    fused = rng.randn(3, 4, 16, H, W).astype(np.float32)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    got = tinf.fuse_routing(torch.from_numpy(raw), torch.from_numpy(fused),
                            torch.from_numpy(mask))
    hwj = lambda t: jnp.asarray(np.moveaxis(t, -3, -1))
    ref = np.moveaxis(np.asarray(jinf.fuse_routing(hwj(raw), hwj(fused),
                                                   jnp.asarray(mask))), -1, -3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-7)
    raw_t = torch.from_numpy(raw)
    assert tinf.fuse_routing(raw_t, None, None) is raw_t  # no aggregation: raw
    assert torch.equal(tinf.fuse_routing(torch.from_numpy(raw), torch.from_numpy(fused),
                                         torch.from_numpy(mask), enabled=False),
                       torch.from_numpy(raw))
