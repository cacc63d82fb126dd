"""posetpu_torch.models.quant against posetpu.models.quant on the same weights
(carried across with models/convert.from_jax_variables) and inputs.

- BN folding and weight quantization: int8 weights equal, scales and biases
  within 1 ulp;
- calibration: activation scales within rtol 1e-5 (float convs sum in
  another order in each framework);
- the int8 serving forward, given the JAX side's own qparams
  (convert.from_jax_params): heatmaps equal to JAX
  ``quantize_pose_resnet(jns_head="phase", phase_kernel="interpret2",
  stem_s2d="pre", subpixel_deconvs={"deconv0"}, act4=<layer1/2>)``, at
  ResNet-18 with 64x64 input and ResNet-50 (Bottleneck blocks) with 32x32,
  bit for bit where the head's f32 epilogue is rounded once, as XLA on the
  CPU contracts it into an FMA (:func:`fma_head`); the port's own
  epilogue rounds multiply and add separately, and differs from that by at
  most one rounding of the product and one of the result.
"""

from __future__ import annotations

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params, from_jax_variables
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.ops import phase_tail as tpt
from tests.test_quant import _trained_like_variables

ACT4 = tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
    f"layer2_{i}.out" for i in range(4))


def fma_head(z, wh, vh):
    """The B1 head's plain version with ``acc * scale + bias`` rounded once
    (exact in f64 for these magnitudes, then one f32 rounding): what XLA
    on the CPU computes for the JAX kernel in interpret mode."""
    _, n, h2, w2, c = z.shape
    zp = z.reshape(4, n, h2 // 2, 2, w2 // 2, 2, c).permute(1, 0, 3, 5, 2, 4, 6)
    acc = torch._int_mm(zp.reshape(-1, c), wh.t().contiguous())
    y = (acc.double() * vh[0].double() + vh[1].double()).float()
    return y.reshape(n, 4 * h2 * w2, -1).permute(2, 0, 1).contiguous()


def assert_head_rounding_only(got, ref, vh):
    """got (separately rounded epilogue) vs ref (FMA): within one rounding
    of the product ``acc * scale`` plus one of the result."""
    bias = vh[1].numpy().reshape((-1,) + (1,) * (ref.ndim - 1))
    bound = np.spacing(np.abs(ref - bias)) * 2 + np.spacing(np.abs(ref))
    assert (np.abs(got - ref) <= bound).all()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(variables, num_layers):
    model = PoseResNet(num_layers=num_layers)
    model.load_state_dict(from_jax_variables(_np_tree(variables)))
    return model.eval()


def test_fold_and_quantize_weights_match_jax(rng):
    jmodel, variables = _trained_like_variables(rng)
    model = _port_model(variables, 18)
    ref = jq.fold_params(jmodel, variables)
    got = tq.fold_params(model)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_max_ulp(got[k][0], np.asarray(ref[k][0]), maxulp=1)
        np.testing.assert_array_max_ulp(got[k][1], np.asarray(ref[k][1]), maxulp=1)

    scales = {"input": 0.02}  # weight quantization reads no activation scale
    qr = jq.quantize_weights(ref, scales, {"deconv0"}, stem_s2d="pre")
    qg = tq.quantize_weights(got, scales, {"deconv0"}, stem_s2d="pre",
                             device="cpu")
    for k in ref:
        np.testing.assert_array_equal(qg["weights"][k].numpy(),
                                      np.asarray(qr["weights"][k]), err_msg=k)
        np.testing.assert_array_max_ulp(qg["w_scales"][k].numpy(),
                                        np.asarray(qr["w_scales"][k]), maxulp=1)
        np.testing.assert_array_max_ulp(qg["biases"][k].numpy(),
                                        np.asarray(qr["biases"][k]), maxulp=1)


def test_calibrate_matches_jax(rng):
    jmodel, variables = _trained_like_variables(rng)
    model = _port_model(variables, 18)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    _, ref = jq.calibrate(jmodel, variables, calib)
    _, got = tq.calibrate(model, calib, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("num_layers,size", [(18, 64), (50, 32)])
def test_int8_forward_bitexact_with_carried_qparams(rng, monkeypatch,
                                                    num_layers, size):
    jmodel, variables = _trained_like_variables(rng, num_layers=num_layers)
    calib = [rng.randn(2, size, size, 3).astype(np.float32)]
    qparams, jfwd = jq.quantize_pose_resnet(
        jmodel, variables, calib, jns_head="phase", phase_kernel="interpret2",
        stem_s2d="pre", subpixel_deconvs={"deconv0"}, act4=ACT4, act4_mode="s4")
    # s2d-packed int8 input, as the u8 front end delivers it
    x = rng.randint(-127, 128, (3, size // 2, size // 2, 12)).astype(np.int8)
    ref = np.asarray(jfwd(qparams, jnp.asarray(x)))

    model = _port_model(variables, num_layers)
    _, fwd = tq.quantize_pose_resnet(model, calib, jns_head="phase", phase_kernel=2,
                                     stem_s2d="pre", subpixel_deconvs={"deconv0"},
                                     act4=ACT4, act4_mode="s4", device="cpu")
    carried = from_jax_params({"q": _np_tree(qparams), "qagg": None}, "cpu")["q"]
    got = fwd(carried, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (16, 3, (size // 4) ** 2)
    assert np.std(got) > 0
    assert_head_rounding_only(got, ref, carried["phase_tail2"]["vh"])

    monkeypatch.setattr(tpt, "_phase_head_plain", fma_head)
    np.testing.assert_array_equal(fwd(carried, torch.from_numpy(x)).numpy(), ref)


def test_quantize_pose_resnet_defaults_match_jax():
    """The same call builds the same model in both packages: every argument
    the two ``quantize_pose_resnet`` share has the same default (the JAX
    one's: row-major heads, the 7x7 stem, no kernel, the packed act4
    carrier)."""
    import inspect

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    jax_d, port_d = defaults(jq.quantize_pose_resnet), defaults(tq.quantize_pose_resnet)
    shared = set(jax_d) & set(port_d)
    assert shared >= {"subpixel_deconvs", "jns_head", "stem_s2d", "phase_kernel", "act4",
                      "act4_mode"}
    assert {k: port_d[k] for k in shared} == {k: jax_d[k] for k in shared}
    assert set(port_d) - set(jax_d) == {"device"}
