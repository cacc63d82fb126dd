"""The rest of the serving scope against the JAX package, on the same numpy
inputs: the S-minor ([J, ..., S]) decode and flip test, the per-pair int8
aggregation bank, the s2d mirror, ``build_serving_pipeline(aggre_kernel=
False)`` and the models' ``dtype``.

- decode (``decode_heatmaps_jns``, ``decode_heatmaps_hwj``), the flip moves
  and ``flip_test_merge_jns``: equal to JAX's, ties included;
- ``final_preds_jns`` on an int8 tail's S-minor heatmaps
  (``quantize_pose_resnet(jns_head=True | "bf16")``): maxvals and preds
  equal (every map's maximum is > 0 there; on one whose maximum is <= 0 the
  port decodes as B7 and the reference do, see core/inference.py);
- ``quantize_aggregation``: the int8 bank and scales equal;
  ``aggregation_int8_apply`` and ``aggregation_int8_apply_jns`` (f32 and
  bf16 maps): equal bit for bit (exact int32 products, ``x_scale * w_scale``
  rounded once, the mean of three values as jnp.mean takes it); the JAX side
  runs op by op, as a call outside ``jax.jit`` does;
- ``mirror_s2d``: equal, and equal to packing the mirrored image;
- ``build_serving_pipeline(aggre_kernel=False)`` (int8 and 4-bit banks):
  preds and maxvals equal to the default pipeline's;
- ``dtype=torch.bfloat16`` (ResNet-18, 64x64, with the bank): the eval
  forward within the bound stated in the test of JAX's ``dtype=bf16``.
"""

from __future__ import annotations

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.core import inference as jinf
from posetpu.models import quant as jq
from posetpu.models.multiview import MultiViewPose as JMultiView
from posetpu.models.pose_resnet import PoseResNet as JPoseResNet
from posetpu.ops import heatmap as jhm
from posetpu_torch.core import inference as tinf
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_variables
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.ops import heatmap as thm
from posetpu_torch.serving import build_serving_pipeline
from tests.test_serving import _small_cfg
from tests.test_torch_serving import _port_model, _request

PAIRS = [(0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)]


def np_variables(rng, heatmap_size=16):
    """Flax variables of a ResNet-18 MultiViewPose with trained-like random
    weights (tests/test_quant.py's statistics: kernels 0.05 N(0, 1), BN
    near identity) and a U(0, 0.1) bank, made in numpy from the port's
    parameter shapes: the inverse of convert.from_jax_variables, so no JAX
    init has to compile."""
    params, stats = {}, {}
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=heatmap_size)
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        r = rng.randn(*t.shape).astype(np.float32)
        if leaf.startswith("running_"):
            tree, leaf = stats, leaf[len("running_"):]
            v = 1.0 + 0.05 * np.abs(r) if leaf == "var" else 0.1 * r
        else:
            tree = params
            if path[-1] == "aggre_layer":
                v = rng.uniform(0.0, 0.1, t.shape).astype(np.float32)
            elif t.dim() == 4 and path[-1].startswith("deconv"):  # flipped HWIO
                v, leaf = (0.05 * r).transpose(2, 3, 0, 1)[::-1, ::-1].copy(), "kernel"
            elif t.dim() == 4:  # OIHW -> HWIO
                v, leaf = (0.05 * r).transpose(2, 3, 1, 0).copy(), "kernel"
            elif leaf == "weight":  # BN scale
                v, leaf = 1.0 + 0.1 * r, "scale"
            else:
                v = 0.1 * r
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = np.asarray(v, np.float32)
    return {"params": params, "batch_stats": stats}


def _maps(rng, *shape):
    """Random maps with explicit ties and a map whose max is <= 0."""
    hm = rng.randn(*shape).astype(np.float32)
    hm[0, 0, ..., 5] = hm[0, 0, ..., 200] = 9.0  # a two-pixel tie
    hm[1, 0] = -np.abs(hm[1, 0])  # max <= 0: coords (0, 0), no nudge
    return hm


@pytest.mark.parametrize("post_process", [True, False])
def test_decode_jns_and_hwj_match_jax(rng, post_process):
    hm = _maps(rng, 16, 2, 4, 256)
    c, m = thm.decode_heatmaps_jns(torch.from_numpy(hm), (16, 16), post_process)
    rc, rm = jhm.decode_heatmaps_jns(jnp.asarray(hm), (16, 16), post_process)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))

    hwj = np.moveaxis(hm.reshape(16, 2, 4, 16, 16), 0, -1)  # [N, V, h, w, J]
    c, m = thm.decode_heatmaps_hwj(torch.from_numpy(hwj), post_process)
    rc, rm = jhm.decode_heatmaps_hwj(jnp.asarray(hwj), post_process)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


@pytest.mark.parametrize("shift", [False, True])
def test_flip_moves_and_merge_jns_match_jax(rng, shift):
    hm, hm_f = (rng.rand(16, 2, 4, 16 * 12).astype(np.float32) for _ in range(2))
    hw = (16, 12)
    np.testing.assert_array_equal(
        thm.flip_back_jns(torch.from_numpy(hm_f), PAIRS, hw).numpy(),
        np.asarray(jhm.flip_back_jns(jnp.asarray(hm_f), PAIRS, hw)))
    np.testing.assert_array_equal(
        thm.shift_heatmap_right_jns(torch.from_numpy(hm), hw).numpy(),
        np.asarray(jhm.shift_heatmap_right_jns(jnp.asarray(hm), hw)))
    np.testing.assert_array_equal(
        tinf.flip_test_merge_jns(torch.from_numpy(hm), torch.from_numpy(hm_f), PAIRS, hw,
                                 shift=shift).numpy(),
        np.asarray(jinf.flip_test_merge_jns(jnp.asarray(hm), jnp.asarray(hm_f), PAIRS, hw,
                                            shift=shift)))


@pytest.mark.parametrize("jns_head", [True, "bf16"])
def test_final_preds_jns_on_the_int8_tail_matches_jax(rng, jns_head):
    """An int8 tail's S-minor maps [J, N*V, S] (the port's, equal to JAX's
    by tests/test_torch_heads.py) through both ``final_preds_jns``: the
    same decode and the same inverse affine, in f32 and from a bf16 tail."""
    model = PoseResNet(num_layers=18)
    model.load_state_dict(from_jax_variables(
        {k: v["resnet"] for k, v in np_variables(rng).items()}))
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    q, fwd = tq.quantize_pose_resnet(model.eval(), calib, jns_head=jns_head, device="cpu")
    hm = fwd(q, torch.from_numpy(rng.randn(8, 64, 64, 3).astype(np.float32)))
    assert hm.dtype == (torch.bfloat16 if jns_head == "bf16" else torch.float32)
    hm = hm.reshape(16, 2, 4, 256)
    center = (400 + 200 * rng.rand(2, 4, 2)).astype(np.float32)
    scale = (1 + 2 * rng.rand(2, 4, 2)).astype(np.float32)
    p, m = tinf.final_preds_jns(hm, torch.from_numpy(center), torch.from_numpy(scale),
                                (16, 16))
    jhm_ = jnp.asarray(hm.float().numpy()).astype(jnp.bfloat16 if jns_head == "bf16"
                                                  else jnp.float32)
    rp, rm = jinf.final_preds_jns(jhm_, jnp.asarray(center), jnp.asarray(scale), (16, 16))
    assert tuple(p.shape) == (2, 4, 16, 2) and float(m.std()) > 0 and (m > 0).all()
    np.testing.assert_array_equal(m.float().numpy(), np.asarray(rm, np.float32))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))


def test_quantize_aggregation_matches_jax(rng):
    bank = rng.uniform(0, 0.1, (12, 64, 64)).astype(np.float32)
    hm = rng.uniform(0, 1.3, (2, 4, 8, 8, 3)).astype(np.float32)
    for calib in (None, hm):
        ref = jq.quantize_aggregation(bank, calib_heatmaps=calib)
        got = tq.quantize_aggregation(torch.from_numpy(bank), calib_heatmaps=calib,
                                      device="cpu")
        assert got["wq"].dtype == torch.int8
        for k in ("wq", "w_scale", "x_scale"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("layout,dtype", [("nhwc", "float32"), ("jns", "float32"),
                                          ("jns", "bfloat16")])
def test_aggregation_int8_apply_matches_jax_bit_for_bit(rng, layout, dtype):
    """An identity-like bank (the reference's ChannelWiseFC regime) and maps
    with a calibrated scale: exact int32 products, the same f32 epilogue."""
    s, j, n = 8, 5, 2
    bank = rng.uniform(0, 0.1, (12, s * s, s * s)).astype(np.float32)
    bank += np.eye(s * s, dtype=np.float32)[None]
    hm = rng.uniform(0, 1, (n, 4, s, s, j)).astype(np.float32)
    qagg_j = jq.quantize_aggregation(bank, calib_heatmaps=hm)
    qagg_t = tq.quantize_aggregation(bank, calib_heatmaps=hm, device="cpu")
    if layout == "nhwc":
        ref = np.asarray(jq.aggregation_int8_apply(qagg_j, jnp.asarray(hm)))
        got = tq.aggregation_int8_apply(qagg_t, torch.from_numpy(hm))
    else:
        hm_jns = np.ascontiguousarray(np.moveaxis(hm.reshape(n, 4, s * s, j), 3, 0))
        jx = jnp.asarray(hm_jns).astype(getattr(jnp, dtype))
        ref = jq.aggregation_int8_apply_jns(qagg_j, jx)
        assert ref.dtype == jx.dtype  # the bf16 tail stays bf16
        ref = np.asarray(ref.astype(jnp.float32))
        got = tq.aggregation_int8_apply_jns(qagg_t, torch.from_numpy(hm_jns).to(
            getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == ref.shape and float(got.float().std()) > 0
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_mirror_s2d_matches_jax(rng):
    img = rng.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    packed = tq._s2d(torch.from_numpy(img))
    got = tq.mirror_s2d(packed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.mirror_s2d(np.asarray(packed))))
    np.testing.assert_array_equal(got.numpy(),
                                  tq._s2d(torch.from_numpy(img[:, :, ::-1].copy())).numpy())


@pytest.mark.parametrize("agg_w4", [False, True])
def test_serving_without_the_aggregation_kernel_equals_the_default(rng, agg_w4):
    cfg = _small_cfg()
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    model = _port_model(np_variables(rng))
    pipe = build_serving_pipeline(cfg, model, calib, agg_w4=agg_w4, device="cpu")
    plain = build_serving_pipeline(cfg, model, calib, agg_w4=agg_w4, aggre_kernel=False,
                                   device="cpu")
    images, center, scale, is_h36m = _request(rng)
    args = (torch.from_numpy(center), torch.from_numpy(scale), torch.from_numpy(is_h36m))
    p, m = pipe.infer(pipe.params, pipe.prepare(images), *args)
    p2, m2 = plain.infer(pipe.params, plain.prepare(images), *args)
    assert torch.equal(p, p2) and torch.equal(m, m2) and float(m.std()) > 0


def test_bf16_forward_within_bound_of_jax(rng):
    """MultiViewPose(dtype=bf16) in eval mode on the same weights and
    views: parameters f32, convs and BN in bf16, heatmaps leaving in f32.
    bf16 carries 8 bits, so the two frameworks' different rounding points
    (the BN epilogue's association, the bank's f32 accumulation order) give
    heatmaps within 2 % of their range, not equal; the fused maps too."""
    variables = np_variables(rng)
    views = rng.randn(2, 4, 64, 64, 3).astype(np.float32)
    jmodel = JMultiView(resnet=JPoseResNet(num_layers=18, dtype=jnp.bfloat16), aggre=True,
                        dtype=jnp.bfloat16)
    raw_j, fused_j, low_j, _ = jmodel.apply(variables, jnp.asarray(views), train=False)
    model = MultiViewPose(PoseResNet(num_layers=18, dtype=torch.bfloat16), heatmap_size=16,
                          dtype=torch.bfloat16)
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        raw, fused, low, _ = model.eval()(torch.from_numpy(views))
    assert raw.dtype == fused.dtype == torch.float32 and low.dtype == torch.bfloat16
    assert low_j.dtype == jnp.bfloat16
    for got, ref in ((raw, raw_j), (fused, fused_j)):
        ref = np.asarray(ref)
        span = ref.max() - ref.min()
        assert span > 0 and np.abs(got.numpy() - ref).max() <= 0.02 * span
    # f32 is what bf16 approximates: the bf16 forward is closer to it than the bound
    model32 = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    model32.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        raw32 = model32.eval()(torch.from_numpy(views))[0]
    assert float((raw - raw32).abs().max()) <= 0.02 * float(raw32.max() - raw32.min())
