"""The port's serving slice end to end against the JAX package.

``posetpu_torch.serving.build_serving_pipeline(device="cpu")`` is built from
the same weights (carried with models/convert.from_jax_variables) and given
the JAX pipeline's own params (convert.from_jax_params), then held against
``posetpu.serving.build_serving_pipeline(interpret=True)`` on the same
images, centers, scales and fuse-routing mask: at the defaults, with the
flip test (in ``infer`` and premirrored), with the 4-bit aggregation bank and
with the dilated deconv0. The tolerances are tests/test_serving.py's: XLA may
contract the f32 epilogues and the routing lerp into FMAs, which the port
rounds in two steps. ``build_float_pipeline`` is held against the JAX
package's float functions called in the same order."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.geometry import triangulate as jtri
from posetpu.data import synthetic as jsyn
from posetpu.serving import build_serving_pipeline as jax_pipeline
from posetpu.serving import pack_hwcn as jax_pack_hwcn
from posetpu_torch.data import synthetic as tsyn
from posetpu_torch.geometry import triangulate as ttri
from posetpu_torch.models.convert import from_jax_params, from_jax_variables
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.ops import aggregation as tagg
from posetpu_torch.serving import build_serving_pipeline, pack_hwcn
from tests.test_quant import _trained_like_variables
from tests.test_serving import _small_cfg

N, V = 2, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(rng):
    """R18 weights plus a plain U(0, 0.1) aggregation bank (the reference's
    ChannelWiseFC init) for 16x16 heatmaps."""
    _, res_vars = _trained_like_variables(rng)
    bank = rng.uniform(0.0, 0.1, (12, 256, 256)).astype(np.float32)
    return {"params": {"resnet": res_vars["params"],
                       "aggre_layer": {"weight": jnp.asarray(bank)}},
            "batch_stats": {"resnet": res_vars["batch_stats"]}}


def _port_model(variables):
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    model.load_state_dict(from_jax_variables(_np_tree(variables)))
    return model.eval()


def test_serving_slice_matches_jax(rng):
    cfg = _small_cfg()
    variables = _variables(rng)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    jpipe = jax_pipeline(cfg, variables, calib, interpret=True)
    pipe = build_serving_pipeline(cfg, _port_model(variables), calib, device="cpu")

    images = rng.randint(0, 256, (N, V, 64, 64, 3)).astype(np.uint8)
    center = (100 + 50 * rng.rand(N, V, 2)).astype(np.float32)
    scale = (1 + rng.rand(N, V, 2)).astype(np.float32)
    is_h36m = np.asarray([1.0, 0.0], np.float32)
    ref_preds, ref_maxvals = jpipe.infer(
        jpipe.params, jnp.asarray(jpipe.prepare(images)), jnp.asarray(center),
        jnp.asarray(scale), jnp.asarray(is_h36m))

    x = pipe.prepare(images)
    assert x.dtype == torch.uint8 and tuple(x.shape) == (32, 32, 12, N * V)
    args = (torch.from_numpy(center), torch.from_numpy(scale), torch.from_numpy(is_h36m))
    carried = from_jax_params(_np_tree(jpipe.params), "cpu")
    preds, maxvals = pipe.infer(carried, x, *args)
    assert tuple(preds.shape) == (N, V, 16, 2) and tuple(maxvals.shape) == (N, V, 16)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_maxvals),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref_preds), atol=1e-4)
    assert float(maxvals.std()) > 0

    # the port's own calibration lands on the same int8 weights, and its
    # pipeline serves finite, non-degenerate outputs
    for k, w in pipe.params["q"]["weights"].items():
        np.testing.assert_array_equal(w.numpy(), carried["q"]["weights"][k].numpy())
    np.testing.assert_array_equal(pipe.params["qagg"]["wq"].numpy(),
                                  carried["qagg"]["wq"].numpy())
    own_preds, own_maxvals = pipe.infer(pipe.params, x, *args)
    assert torch.isfinite(own_preds).all() and float(own_maxvals.std()) > 0


def _request(rng):
    images = rng.randint(0, 256, (N, V, 64, 64, 3)).astype(np.uint8)
    center = (100 + 50 * rng.rand(N, V, 2)).astype(np.float32)
    scale = (1 + rng.rand(N, V, 2)).astype(np.float32)
    is_h36m = np.asarray([1.0, 0.0], np.float32)
    return images, center, scale, is_h36m


def test_serving_flip_test_matches_jax_and_premirrored(rng):
    """flip_test=True mirrors inside infer, "premirrored" inside prepare:
    the same bytes reach the u8 affine, so the two are equal exactly; both
    are within the serving bound of the JAX pipeline with flip_test=True."""
    cfg = _small_cfg()
    variables = _variables(rng)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    jpipe = jax_pipeline(cfg, variables, calib, flip_test=True, interpret=True)
    model = _port_model(variables)
    pipe_dev = build_serving_pipeline(cfg, model, calib, flip_test=True, device="cpu")
    pipe_pre = build_serving_pipeline(cfg, model, calib, flip_test="premirrored",
                                      device="cpu")
    with pytest.raises(ValueError, match="flip_test"):
        build_serving_pipeline(cfg, model, calib, flip_test="mirrored", device="cpu")

    images, center, scale, is_h36m = _request(rng)
    ref_preds, ref_maxvals = jpipe.infer(
        jpipe.params, jnp.asarray(jpipe.prepare(images)), jnp.asarray(center),
        jnp.asarray(scale), jnp.asarray(is_h36m))
    args = (torch.from_numpy(center), torch.from_numpy(scale), torch.from_numpy(is_h36m))
    carried = from_jax_params(_np_tree(jpipe.params), "cpu")
    x_dev, x_pre = pipe_dev.prepare(images), pipe_pre.prepare(images)
    assert tuple(x_dev.shape) == (32, 32, 12, N * V)
    assert tuple(x_pre.shape) == (32, 32, 12, 2 * N * V)
    p1, m1 = pipe_dev.infer(carried, x_dev, *args)
    p2, m2 = pipe_pre.infer(carried, x_pre, *args)
    assert torch.equal(p1, p2) and torch.equal(m1, m2)
    np.testing.assert_allclose(m1.numpy(), np.asarray(ref_maxvals), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p1.numpy(), np.asarray(ref_preds), atol=1e-4)
    # the merge changes the result: not the unflipped pipeline's output
    p0, m0 = build_serving_pipeline(cfg, model, calib, device="cpu").infer(
        carried, x_dev, *args)
    assert not torch.equal(m0, m1)


def test_serving_agg_w4_dilated_deconv0_matches_jax(rng):
    """agg_w4=True (the diag-split 4-bit bank, B4's plain version here) with
    subpixel_deconvs=False (deconv0 as the dilated int8 conv) against the
    JAX pipeline built the same way; the bank is nibble-packed."""
    from posetpu_torch.serving import finalize_device_params

    cfg = _small_cfg()
    variables = _variables(rng)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    jpipe = jax_pipeline(cfg, variables, calib, agg_w4=True, subpixel_deconvs=False,
                         interpret=True)
    pipe = build_serving_pipeline(cfg, _port_model(variables), calib, agg_w4=True,
                                  subpixel_deconvs=False, device="cpu")
    images, center, scale, is_h36m = _request(rng)
    ref_preds, ref_maxvals = jpipe.infer(
        jpipe.params, jnp.asarray(jpipe.prepare(images)), jnp.asarray(center),
        jnp.asarray(scale), jnp.asarray(is_h36m))
    args = (torch.from_numpy(center), torch.from_numpy(scale), torch.from_numpy(is_h36m))
    carried = from_jax_params(_np_tree(jpipe.params), "cpu")
    # the bank carried across nibble-packed, with sv folded once
    assert set(carried["qagg"]) == {"wq4", "w_scale", "dv", "x_scale", "sv"}
    assert torch.equal(carried["qagg"]["sv"], tagg.fold_sv(carried["qagg"]))
    assert carried["qagg"]["wq4"].dtype == torch.uint8
    assert carried["qagg"]["wq4"].numel() == 4 * 3 * 256 * 256 // 2
    assert "subpix_deconv0" not in carried["q"] and "phase_tail2" in carried["q"]
    for k, v in pipe.params["qagg"].items():
        assert torch.equal(v, carried["qagg"][k]), k
    assert finalize_device_params(carried) is carried

    preds, maxvals = pipe.infer(carried, pipe.prepare(images), *args)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_maxvals),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref_preds), atol=1e-4)
    assert float(maxvals.std()) > 0


@pytest.mark.parametrize("flip_test", [False, True])
def test_float_pipeline_matches_jax_functions(rng, flip_test):
    """build_float_pipeline against the JAX package's float functions in the
    validate loop's order: the flax MultiViewPose forward, fuse_routing, the
    flip-test merge (with the shift), final_preds. Heatmaps agree to atol
    1e-4 (test_from_jax_variables_float_forward_matches_flax's bound), so
    maxvals are held to that; on these inputs every joint decodes to the
    same pixel and nudge, so preds are held to the serving tests' atol 1e-4
    (the inverse affine's rounding)."""
    from posetpu.core import inference as jinf
    from posetpu.data.base import union_flip_pairs
    from posetpu.models.multiview import MultiViewPose as FlaxMultiView
    from posetpu.models.pose_resnet import PoseResNet as FlaxPoseResNet
    from posetpu_torch.serving import build_float_pipeline

    cfg = _small_cfg()
    cfg.TEST.POST_PROCESS = True
    cfg.TEST.SHIFT_HEATMAP = True
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 0.5 if getattr(p[-1], "key", "") == "kernel" else v,
        _variables(rng))
    views = rng.randn(N, V, 64, 64, 3).astype(np.float32)
    center = (100 + 50 * rng.rand(N, V, 2)).astype(np.float32)
    scale = (1 + rng.rand(N, V, 2)).astype(np.float32)
    is_h36m = np.asarray([1.0, 0.0], np.float32)

    flax_model = FlaxMultiView(FlaxPoseResNet(num_layers=18))
    pairs = union_flip_pairs()

    def routed(x, mask):
        raw, fused, _, _ = flax_model.apply(variables, jnp.asarray(x), train=False)
        return jinf.fuse_routing(raw, fused, jnp.asarray(mask))

    if flip_test:
        out2 = routed(np.concatenate([views, views[..., ::-1, :]], axis=0),
                      np.concatenate([is_h36m, is_h36m]))
        output = jinf.flip_test_merge(out2[:N], out2[N:], pairs, shift=True)
    else:
        output = routed(views, is_h36m)
    # decode_heatmaps over [..., J, h, w]: the decode final_preds' port uses
    from posetpu.ops.affine import transform_preds
    from posetpu.ops.heatmap import decode_heatmaps

    coords, ref_maxvals = decode_heatmaps(jnp.moveaxis(output, -1, -3))
    ref_preds = transform_preds(coords, jnp.asarray(center), jnp.asarray(scale), (16, 16))

    pipe = build_float_pipeline(cfg, _port_model(variables), flip_test=flip_test,
                                device="cpu")
    preds, maxvals = pipe.infer(pipe.params, pipe.prepare(views), torch.from_numpy(center),
                                torch.from_numpy(scale), torch.from_numpy(is_h36m))
    assert tuple(preds.shape) == (N, V, 16, 2) and tuple(maxvals.shape) == (N, V, 16)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_maxvals), atol=1e-4)
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref_preds), atol=1e-4)
    assert float(maxvals.std()) > 0


def test_pack_hwcn_matches_jax(rng):
    x = rng.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    got = pack_hwcn(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), jax_pack_hwcn(x))


def test_triangulate_points_matches_jax(rng):
    g = 3
    jcams = jsyn.tile_cameras(jsyn.make_camera_ring(), g)
    tcams = tsyn.tile_cameras(tsyn.make_camera_ring(), g)
    for a, b in zip(jcams, tcams):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pts3d = jsyn.make_skeleton_poses(g, seed=3)
    poses2d = np.stack([np.asarray(jax.vmap(
        lambda p, c: jtri.project_points(p, c), in_axes=(0, 0))(
            jnp.asarray(pts3d), jax.tree.map(lambda t: t[:, v], jcams)))
        for v in range(4)], axis=1)  # [G, V, J, 2]
    poses2d = poses2d + rng.randn(*poses2d.shape).astype(np.float32)
    vis = (rng.rand(g, 4, 16) > 0.3).astype(np.float32)
    vis[0, :3, 0] = 0.0  # one joint seen by a single view -> zeros

    ref = np.asarray(jtri.triangulate_points(jnp.asarray(poses2d), jcams,
                                             jnp.asarray(vis)))
    got = ttri.triangulate_points(torch.from_numpy(poses2d), tcams,
                                  torch.from_numpy(vis)).numpy()
    assert got.shape == (g, 16, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    assert (got[0, 0] == 0).all()


def test_from_jax_variables_float_forward_matches_flax(rng):
    """The float MultiViewPose forward on converted weights equals the flax
    forward (heatmaps and the aggregated heatmaps)."""
    from posetpu.models.multiview import MultiViewPose as FlaxMultiView
    from posetpu.models.pose_resnet import PoseResNet as FlaxPoseResNet

    variables = _variables(rng)
    # scale the kernels down so activations stay O(1) through 18 layers and
    # atol 1e-4 is a tight bound
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 0.5 if getattr(p[-1], "key", "") == "kernel" else v,
        variables)
    views = rng.randn(1, 4, 64, 64, 3).astype(np.float32)
    ref = FlaxMultiView(FlaxPoseResNet(num_layers=18)).apply(
        variables, jnp.asarray(views), train=False)
    with torch.no_grad():
        got = _port_model(variables)(torch.from_numpy(views))
    for r, g_ in zip(ref, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), atol=1e-4, rtol=0)
