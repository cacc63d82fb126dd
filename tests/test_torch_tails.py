"""The port's other deconv tails against the JAX package, on the same numpy
inputs and the JAX side's own quantized params (convert.from_jax_params).

- B5's and B6's plain versions against ``fused_phase_tail(interpret=True)``
  and ``fused_subpixel_deconv(interpret=True)``: int8 maps equal; the head's
  f32 output equal except where XLA on the CPU contracted ``acc * scale +
  bias`` into one FMA, and then within one rounding of the product plus one
  of the result (the bound tests/test_torch_phase_tail.py states);
- the kernels' argument packs (``build_phase_tail_args``): equal arrays;
- the whole int8 forward at ``phase_kernel`` False, 1 and 2 and at
  ``subpixel_deconvs`` False, {"deconv0"} and {"deconv0", "deconv1"}, with
  both settings of ``SUBPIX_BATCHED``: the same head-rounding bound (every
  int8 stage before the head is exact, or the bound would not hold);
  ``subpixel_deconvs=True`` names the phase tail's own deconvs, which both
  packages refuse;
- the dilated int8 conv at deconv kernels 3 and 2: equal to the JAX runner's
  stage on the same int8 input.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu.ops.pallas import phase_tail as jpt
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params
from posetpu_torch.ops import phase_tail as tpt
from tests.test_quant import _trained_like_variables
from tests.test_torch_phase_tail import _i8, _qparams, _scales, _subpix_args
from tests.test_torch_quant import _np_tree, _port_model, assert_head_rounding_only


def _tail_args(rng, c, joints):
    return {"w": _i8(rng, 4, 4, c, c),
            "sv": np.stack([_scales(rng, c, lo=2e-3, hi=8e-3),
                            rng.uniform(-20, 20, c).astype(np.float32)]),
            "so": np.asarray([[0.91]], np.float32),
            "wh": _i8(rng, c, joints),
            "vh": np.stack([_scales(rng, joints, lo=1e-4, hi=1e-3),
                            rng.uniform(-1, 1, joints).astype(np.float32)])}


@pytest.mark.parametrize("n,h,w", [(2, 4, 4), (3, 2, 6)])
def test_phase_tail_matches_jax_kernel(rng, n, h, w):
    """B5 at C 32, J 4: f32 heatmaps in the levels=1 packed order."""
    x = _i8(rng, n, h * w, 32)
    args = _tail_args(rng, 32, 4)
    ref = np.asarray(jpt.fused_phase_tail(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in args.items()},
        h=h, w=w, interpret=True))
    dev = tpt.tail_device_args(args, "cpu")
    got = tpt.fused_phase_tail(torch.from_numpy(x), dev, h=h, w=w).numpy()
    assert got.shape == ref.shape == (4, n, 4 * h * w) and np.std(got) > 0

    # the head's exact int32 sums, from the port's own phase maps
    z = tpt._phase_conv_plain(torch.from_numpy(x).reshape(n, h, w, 32), dev["w"],
                              dev["sv"][0], dev["sv"][1], dev["so"], interleave=False)
    acc = (z.permute(1, 0, 2, 3, 4).reshape(-1, 32).long() @ dev["wh"].t().long()).numpy()
    fma = (acc * args["vh"][0].astype(np.float64) + args["vh"][1]).astype(np.float32)
    fma = fma.reshape(n, 4 * h * w, 4).transpose(2, 0, 1)
    prod = (acc.astype(np.float32) * args["vh"][0]).reshape(n, 4 * h * w, 4)
    bound = np.spacing(np.abs(prod.transpose(2, 0, 1))) + np.spacing(np.abs(ref))
    differ = got != ref
    np.testing.assert_array_equal(ref[differ], fma[differ])
    assert (np.abs(got - ref)[differ] <= bound[differ]).all()


@pytest.mark.parametrize("n", [3, 8])
def test_subpixel_deconv_pairs_matches_jax_kernel(rng, n):
    """B6 at Cin 64, Cout 32, 4x4; a batch of 8 takes the TPU kernel's
    image-pair path, 3 its single-image one: int8-equal, N-minor output."""
    h = w = 4
    x = _i8(rng, n, h * w, 64)
    args = _subpix_args(rng, 64, 32)
    ref = jpt.fused_subpixel_deconv(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in args.items()},
        h=h, w=w, interpret=True)
    dev = tpt.subpixel_device_args(args, "cpu")
    got = tpt.fused_subpixel_deconv(torch.from_numpy(x), dev, h=h, w=w)
    assert got.dtype == torch.int8 and tuple(got.shape) == (4, h, w, n, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > 50
    np.testing.assert_array_equal(
        tpt.subpixel_interleave_packed(got).numpy(),
        np.asarray(jpt.subpixel_interleave_packed(ref)))
    # both contracts interleave to the same image
    batched = tpt.fused_subpixel_deconv_batched(torch.from_numpy(x), dev, h=h, w=w)
    assert torch.equal(tpt.subpixel_interleave_packed(got),
                       tpt.subpixel_interleave_packed_nmajor(batched))


def test_phase_tail_args_match_jax(rng):
    q = _qparams(rng)
    ref = jpt.build_phase_tail_args(q, "deconv2", 0.0123)
    got = tpt.build_phase_tail_args(q, "deconv2", 0.0123)
    dev = tpt.tail_device_args(got, "cpu")
    # the device args also carry B5's stage images and padded head
    assert set(got) == set(ref) == set(dev) - {"wt", "wht"}
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        d = dev[k].numpy()
        np.testing.assert_array_equal(np.swapaxes(d, -1, -2) if k in ("w", "wh") else d,
                                      np.asarray(ref[k]), err_msg=k)


D01 = frozenset({"deconv0", "deconv1"})
D0 = frozenset({"deconv0"})
JAX_PHASE_KERNEL = {False: False, 1: "interpret", 2: "interpret2"}


@pytest.mark.parametrize("phase_kernel,subpixel,batched", [
    (False, False, True), (False, D0, True), (False, D01, True),
    (1, False, True), (1, D0, True), (1, D01, True), (1, D01, False),
    (2, False, True), (2, D0, False),
], ids=["plain-dilated", "plain-d0", "plain-d0d1", "k1-dilated", "k1-d0", "k1-d0d1",
        "k1-d0d1-pairs", "k2-dilated", "k2-d0-pairs"])
def test_int8_forward_matches_jax(rng, monkeypatch, phase_kernel, subpixel, batched):
    """ResNet-18, 64x64 input, 16x16 heatmaps, a batch of 3."""
    jmodel, variables = _trained_like_variables(rng)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    monkeypatch.setattr(jpt, "SUBPIX_BATCHED", batched)
    monkeypatch.setattr(tpt, "SUBPIX_BATCHED", batched)
    qparams, jfwd = jq.quantize_pose_resnet(
        jmodel, variables, calib, jns_head="phase",
        phase_kernel=JAX_PHASE_KERNEL[phase_kernel], stem_s2d="pre",
        subpixel_deconvs=subpixel)
    x = rng.randint(-127, 128, (3, 32, 32, 12)).astype(np.int8)
    ref = np.asarray(jfwd(qparams, jnp.asarray(x)))

    own, fwd = tq.quantize_pose_resnet(_port_model(variables, 18), calib,
                                       subpixel_deconvs=subpixel, jns_head="phase",
                                       phase_kernel=phase_kernel, stem_s2d="pre",
                                       device="cpu")
    carried = from_jax_params({"q": _np_tree(qparams), "qagg": None}, "cpu")["q"]
    assert set(own) == set(carried)
    assert ("phase_tail" in own) == (phase_kernel == 1)
    assert ("phase_tail2" in own) == (phase_kernel == 2)
    for k, w in own["weights"].items():
        np.testing.assert_array_equal(w.numpy(), carried["weights"][k].numpy(), err_msg=k)

    before = {f: getattr(tpt, f).launches for f in
              ("fused_phase_tail", "fused_phase_tail2", "fused_subpixel_deconv",
               "fused_subpixel_deconv_batched")}
    got = fwd(carried, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (16, 3, 256) and np.std(got) > 0
    # on the CPU every wrapper ran its plain version: no launch is counted
    assert before == {f: getattr(tpt, f).launches for f in before}
    q = carried
    vh = torch.stack([q["act_scales"]["deconv2.out"] * q["w_scales"]["final"],
                      q["biases"]["final"]])
    assert_head_rounding_only(got, ref, vh)
    assert np.mean(got == ref) > 0.5


def test_dilated_deconvs_k3_and_k2_match_jax(rng):
    """Deconv kernels (3, 2, 4): deconv0 (k3, output padding 1) and deconv1
    (k2, no padding) run the dilated int8 conv with their own paddings. The
    port's calibration (float ConvTranspose2d) lands on the JAX package's
    weights and scales, and each int8 stage equals the JAX runner's
    ``qchain(lhs_dilation=(2, 2))`` exactly on the same int8 input (called
    op by op, so XLA fuses no multiply-add)."""
    from posetpu.models.pose_resnet import PoseResNet as FlaxPoseResNet
    from posetpu_torch.models.convert import from_jax_variables
    from posetpu_torch.models.pose_resnet import PoseResNet

    kernels = (3, 2, 4)
    jmodel = FlaxPoseResNet(num_layers=18, deconv_kernels=kernels)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32), train=False)
    variables = jax.tree.map(
        lambda leaf: jnp.asarray(0.05 * rng.randn(*leaf.shape).astype(np.float32))
        if leaf.ndim == 4 else leaf, variables)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    qparams, _ = jq.quantize_pose_resnet(
        jmodel, variables, calib, jns_head="phase", phase_kernel="interpret",
        stem_s2d="pre", subpixel_deconvs=False)

    model = PoseResNet(num_layers=18, deconv_kernels=kernels)
    model.load_state_dict(from_jax_variables(_np_tree(variables)))
    own, _ = tq.quantize_pose_resnet(model.eval(), calib, subpixel_deconvs=False,
                                     jns_head="phase", phase_kernel=1, stem_s2d="pre",
                                     device="cpu")
    carried = from_jax_params({"q": _np_tree(qparams), "qagg": None}, "cpu")["q"]
    for k, w in own["weights"].items():
        np.testing.assert_array_equal(w.numpy(), carried["weights"][k].numpy(), err_msg=k)
    for k, v in own["act_scales"].items():
        np.testing.assert_allclose(float(v), float(carried["act_scales"][k]), rtol=1e-5)

    jr, tr = jq._Int8Runner(qparams), tq._Int8Runner(carried)
    for name, feeds, cin, hw, k in (("deconv0", "layer4_1.out", 512, 2, 3),
                                    ("deconv1", "deconv0.out", 256, 5, 2)):
        pad, opad = k - 1 - (1 if k in (3, 4) else 0), 1 if k == 3 else 0
        x = rng.randint(0, 128, (2, hw, hw + 1, cin)).astype(np.int8)
        s_h = np.float32(qparams["act_scales"][feeds])  # the stage's own input scale
        with jax.disable_jit():
            ref, _ = jr.qchain(jnp.asarray(x), s_h, name,
                               padding=[(pad, pad + opad)] * 2, lhs_dilation=(2, 2))
        got, _ = tr.qchain(torch.from_numpy(x), torch.tensor(s_h), name, dilated=True)
        out_hw = (2 * hw, 2 * (hw + 1))
        assert tuple(got.shape) == (2, *out_hw, 256) and got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)
        assert len(np.unique(got.numpy())) > 20


def test_phase_tail_deconvs_cannot_be_subpixel(rng):
    """``subpixel_deconvs=True`` (or naming the last deconv) asks for the
    [2, 2, I, 4*O] form of a deconv the phase tail runs in the [4, 4, I, O]
    form: the JAX package fails on it, the port raises ValueError."""
    jmodel, variables = _trained_like_variables(rng)
    calib = [rng.randn(1, 64, 64, 3).astype(np.float32)]
    with pytest.raises(Exception):
        jq.quantize_pose_resnet(jmodel, variables, calib, jns_head="phase",
                                phase_kernel="interpret2", stem_s2d="pre",
                                subpixel_deconvs=True)
    model = _port_model(variables, 18)
    for pk, sub in ((2, True), (1, True), (False, True), (2, D01), (1, {"deconv2"})):
        with pytest.raises(ValueError, match="phase tail"):
            tq.quantize_pose_resnet(model, calib, subpixel_deconvs=sub, jns_head="phase",
                                    phase_kernel=pk, stem_s2d="pre", device="cpu")
    with pytest.raises(ValueError, match="phase_kernel"):
        tq.quantize_pose_resnet(model, calib, jns_head="phase", phase_kernel=3,
                                stem_s2d="pre", device="cpu")
