"""The port's serving slice end to end against the JAX package.

``posetpu_torch.serving.build_serving_pipeline(device="cpu")`` is built from
the same weights (carried with models/convert.from_jax_variables) and given
the JAX pipeline's own params (convert.from_jax_params), then held against
``posetpu.serving.build_serving_pipeline(interpret=True)`` on the same
images, centers, scales and fuse-routing mask. The tolerances are
tests/test_serving.py's: XLA may contract the f32 epilogues and the routing
lerp into FMAs, which the port rounds in two steps."""

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
