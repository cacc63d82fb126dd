"""posetpu_torch.train.qat against posetpu.train.qat on the CPU, ResNet-18 at
64x64 (16x16 maps) with tests/test_quant.py's trained-like weights (made in
numpy: tests/test_torch_serving_jns.np_variables), both sides from the
port's calibration; the JAX side of the bit-for-bit comparisons under
``jax.disable_jit()``, that of the float64 ones jitted (XLA's contractions
move a float64 value by ~1e-16, far inside their bounds, and op by op the
steps take twice as long):

- ``_fake_quant`` and the per-channel weight fake quant: values equal bit
  for bit on inputs that hold exact .5 multiples of the scale, gradients
  the identity in both;
- the fake-quant forward and three QAT steps in float64 (JAX under x64).
  In float32 the fake-quantised forward is chaotic: one activation that a
  conv sum in another order rounds the other way moves a few of the next
  layer's values a step, and those move more; from one flip in layer1,
  10-20 % of deconv2's values end a step or more apart and the first loss
  3e-2 apart (measured). In float64 no value rounds the other way: the
  forward 5e-16 of its range apart, the losses 6e-15, and every int8
  weight, weight scale and bias equal (measured; the last two are f32
  roundings of the tuned float64 values). The bounds leave room above
  that and no more: the forward within 1e-10 relative and 1e-12 of its
  range, the losses within 1e-10 relative, the activation scales, int8
  weights, weight scales and biases equal. A weight fake quant that
  passes no gradient, or Adam's b2 at 0.99, moves the later losses past
  1e-10 relative (checked);
- ``quantize_pose_resnet_qat``'s forward on JAX's tuned qparams: equal bit
  for bit to JAX's int8 forward;
- ``conv_dtype_policy``: JAX's dict at ResNet-18 and ResNet-50 shapes;
- tests/test_qat.py's two checks of the port alone: the fake quant tracks
  the int8 runner, and QAT lowers the int8-vs-float error.

The JAX package's ``_FakeQuantRunner`` has no ``unwrap``, which its
``_forward`` calls at every block: its QAT raises AttributeError as shipped
(ROADMAP C). The JAX side runs here with the identity ``unwrap`` added for
the test's duration."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu.train import qat as jqat
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params, from_jax_variables
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu.models.pose_resnet import PoseResNet as JPoseResNet
from posetpu_torch.train import qat as tqat
from tests.test_torch_serving_jns import np_variables

LR = 3e-6
DKS = (4, 4, 4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _patch_jax_qat(monkeypatch):
    """The JAX QAT runnable: the identity ``unwrap`` its runner lacks, and
    its float64 convs computing in float64 (the package asks XLA for f32
    results)."""
    monkeypatch.setattr(jqat._FakeQuantRunner, "unwrap", lambda self, h, s_h: (h, s_h),
                        raising=False)
    conv = jq._conv

    def conv_in_input_dtype(x, w, stride=1, padding=None, lhs_dilation=None,
                            prefer=jnp.float32):
        if x.dtype == jnp.float64:
            prefer = jnp.float64
        return conv(x, w, stride, padding, lhs_dilation, prefer=prefer)

    monkeypatch.setattr(jq, "_conv", conv_in_input_dtype)
    monkeypatch.setattr(jqat, "_conv", conv_in_input_dtype)


@pytest.fixture
def jax_qat(monkeypatch):
    _patch_jax_qat(monkeypatch)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this module runs: under a parallel test
    run, eight a process oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def r18():
    """The JAX model (its structure; no init) and variables, the port's
    PoseResNet with the same weights, calibration and train batches, and
    the port's calibration, which both sides take."""
    rng = np.random.RandomState(0)
    v = np_variables(rng)
    variables = {"params": v["params"]["resnet"], "batch_stats": v["batch_stats"]["resnet"]}
    model = PoseResNet(num_layers=18)
    model.load_state_dict(from_jax_variables(variables))
    model.eval()
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    train = [rng.randn(2, 64, 64, 3).astype(np.float32) for _ in range(3)]
    folded, scales = tq.calibrate(model, calib, "cpu")
    return SimpleNamespace(jmodel=JPoseResNet(num_layers=18), variables=variables, model=model,
                           calib=calib, train=train, folded=folded, scales=scales)


def _f64(folded):
    return {k: (w.astype(np.float64), b.astype(np.float64)) for k, (w, b) in folded.items()}


def test_fake_quant_values_and_gradients_match_jax(rng):
    """Exact .5 multiples round half to even in both (a power-of-two scale
    makes x / scale exact), and values just off them go the same way under
    a scale that is not one; the clip at +-127; the gradient is the
    identity, none reaching the scale."""
    k = np.arange(-140, 141, dtype=np.float32)
    for s in (np.float32(2.0 ** -5), np.float32(0.0371)):
        x = np.concatenate([(k + 0.5) * s, k * s, rng.randn(4096).astype(np.float32) * 2]
                           ).astype(np.float32)
        g = rng.randn(x.size).astype(np.float32)
        ref = np.asarray(jqat._fake_quant(jnp.asarray(x), float(s)))
        jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jqat._fake_quant(v, float(s)) * g))(
            jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        got = tqat._fake_quant(xt, torch.tensor(float(s)))
        (got * torch.from_numpy(g)).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), ref)
        np.testing.assert_array_equal(xt.grad.numpy(), jgrad)
        np.testing.assert_array_equal(jgrad, g)

    # the weights' per-output-channel fake quant, with .5 multiples of a
    # channel's own scale (its max is 127 steps)
    w = (rng.randint(-127, 128, (3, 3, 8, 6)) + rng.choice([0.0, 0.5], (3, 3, 8, 6))
         ).astype(np.float32) * np.float32(2.0 ** -7)
    w[0, 0, 0] = 127 * 2.0 ** -7
    g = rng.randn(*w.shape).astype(np.float32)
    jrun = jqat._FakeQuantRunner({}, {})
    ref = np.asarray(jrun._fq_w(jnp.asarray(w)))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jrun._fq_w(v) * g))(jnp.asarray(w)))
    trun = tqat._FakeQuantRunner(tqat.FoldedParams({"x": (w, w[0, 0, 0])}, "cpu"), {})
    wt = torch.from_numpy(w).requires_grad_()
    got = trun._fq_w(wt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    np.testing.assert_array_equal(wt.grad.numpy(), jgrad)
    np.testing.assert_array_equal(jgrad, g)


def test_fake_quant_forward_matches_jax(r18, jax_qat):
    x = np.random.RandomState(1).randn(2, 64, 64, 3)
    with jax.enable_x64():
        p = {k: (jnp.asarray(w), jnp.asarray(b)) for k, (w, b) in _f64(r18.folded).items()}
        ref = np.asarray(jax.jit(lambda p, x: jq._forward(
            jqat._FakeQuantRunner(p, r18.scales), x, 18, (256,) * 3, DKS))(p, jnp.asarray(x)))
    params = tqat.FoldedParams(_f64(r18.folded), "cpu")
    got = tq._forward(tqat._FakeQuantRunner(params, r18.scales), torch.from_numpy(x), 18,
                      DKS).detach().numpy()
    assert got.shape == ref.shape == (2, 16, 16, 16) and np.std(ref) > 0
    spread = ref.max() - ref.min()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * spread)


@pytest.fixture(scope="module")
def tuned(r18):
    """Three QAT steps on each side in float64 from one calibration: (JAX
    qparams, JAX info, port qparams, port info)."""
    train64 = [b.astype(np.float64) for b in r18.train]
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax_qat(mp)
        mp.setattr(jqat, "calibrate", lambda model, variables, batches: (
            _f64(r18.folded), dict(r18.scales)))
        with jax.enable_x64():
            jqp, jinfo = jqat.qat_finetune(r18.jmodel, r18.variables, r18.calib, train64, lr=LR)
    jqp = _np_tree(jqp)
    tqp, tinfo = tqat._finetune(_f64(r18.folded), r18.scales, 18, DKS, train64, lr=LR,
                                target_fn=None, device="cpu")
    return jqp, jinfo, tqp, tinfo


def test_qat_finetune_matches_jax(tuned):
    jqp, jinfo, tqp, tinfo = tuned
    assert len(tinfo["losses"]) == len(jinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-10)
    assert set(tqp["act_scales"]) == set(jqp["act_scales"])
    for k, v in jqp["act_scales"].items():
        assert float(tqp["act_scales"][k]) == float(v), k
    assert set(tqp["weights"]) == set(jqp["weights"])
    for k in jqp["weights"]:
        np.testing.assert_array_equal(tqp["weights"][k].numpy(), jqp["weights"][k], err_msg=k)
        np.testing.assert_array_equal(tqp["w_scales"][k].numpy(), jqp["w_scales"][k],
                                      err_msg=k)
        np.testing.assert_array_equal(tqp["biases"][k].numpy(), jqp["biases"][k], err_msg=k)


def test_qat_forward_on_jax_tuned_qparams_is_bitexact(r18, tuned):
    """quantize_pose_resnet_qat's forward (the int8 runner, no act4, the
    dilated deconvs) on JAX's tuned qparams carried across."""
    jqp = tuned[0]
    x = np.random.RandomState(2).randn(3, 64, 64, 3).astype(np.float32)
    with jax.disable_jit():  # JAX's quantize_pose_resnet_qat forward, op by op
        q = jax.tree.map(jnp.asarray, jqp)
        ref = np.asarray(jq._forward(jq._Int8Runner(q, jq.conv_dtype_policy(q)),
                                     jnp.asarray(x), 18, (256,) * 3, DKS))
    _, fwd, info = tqat.quantize_pose_resnet_qat(r18.model, r18.calib, [], device="cpu")
    assert info == {"losses": []}
    got = fwd(from_jax_params({"q": jqp}, "cpu")["q"], torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 16, 16, 16) and np.std(ref) > 0
    np.testing.assert_array_equal(got, ref)


def test_qat_finetune_is_calibrate_then_finetune(r18, monkeypatch):
    """The public entry point runs the port's calibration, then the steps
    (in f32) on its result."""
    folded, scales = tq.calibrate(r18.model, r18.calib, "cpu")
    seen = {}

    def finetune(f, s, nl, dks, batches, **kw):
        seen.update(f=f, s=s, nl=nl, dks=tuple(dks), batches=list(batches), **kw)
        return "q", "info"

    monkeypatch.setattr(tqat, "_finetune", finetune)
    assert tqat.qat_finetune(r18.model, r18.calib, r18.train[:1], lr=1e-5,
                             device="cpu") == ("q", "info")
    assert seen["s"] == scales and seen["nl"] == 18 and seen["dks"] == DKS
    assert seen["lr"] == 1e-5 and seen["target_fn"] is None and len(seen["batches"]) == 1
    assert all(np.array_equal(seen["f"][k][0], w) for k, (w, _) in folded.items())


@pytest.mark.parametrize("num_layers", [18, 50])
def test_conv_dtype_policy_matches_jax(num_layers):
    folded = tq.fold_params(PoseResNet(num_layers=num_layers))
    for sub, s2d in ((False, False), ({"deconv0"}, True)):
        q = tq.quantize_weights(folded, {}, sub, stem_s2d=s2d, device="cpu")
        shapes = {"weights": {k: np.zeros(tuple(v.shape), np.int8)
                              for k, v in q["weights"].items()}}
        got = tq.conv_dtype_policy(shapes)
        assert got == jq.conv_dtype_policy(shapes) and got
        assert set(got.values()) == {"bf16"}


def _int8_fwd(model, qparams, x):
    with torch.no_grad():
        return tq._forward(tq._Int8Runner(qparams), torch.as_tensor(x), model.num_layers,
                           model.deconv_kernels).numpy()


def test_fake_quant_tracks_the_int8_runner(r18):
    """tests/test_qat.py::test_fake_quant_matches_int8_runner on the port:
    with the same weights and scales the fake-quant forward predicts the
    int8 runner's (both quantise at the same points)."""
    model, calib = r18.model, r18.calib
    qparams, _ = tq.quantize_pose_resnet(model, calib, device="cpu")
    folded, scales = tq.calibrate(model, calib, "cpu")
    x = torch.from_numpy(calib[0])
    with torch.no_grad():
        fq = tq._forward(tqat._FakeQuantRunner(tqat.FoldedParams(folded, "cpu"), scales), x,
                         18, DKS).numpy()
    q = _int8_fwd(model, qparams, x)
    err = np.abs(fq - q).max()
    spread = np.abs(q).max() + 1e-6
    assert err / spread < 0.05, (err, spread)


def test_qat_reduces_quantization_error(r18):
    """tests/test_qat.py::test_qat_reduces_quantization_error on the port:
    24 distillation steps shrink the int8-vs-float gap below PTQ's."""
    model, calib = r18.model, r18.calib
    rng = np.random.RandomState(3)
    train = [rng.randn(2, 64, 64, 3).astype(np.float32) for _ in range(8)]
    with torch.no_grad():
        float_hm = model(torch.from_numpy(calib[0]))[0].numpy()
    ptq, _ = tq.quantize_pose_resnet(model, calib, device="cpu")
    ptq_err = float(np.mean((_int8_fwd(model, ptq, calib[0]) - float_hm) ** 2))
    qat, info = tqat.qat_finetune(model, calib, train * 3, lr=LR, device="cpu")
    qat_err = float(np.mean((_int8_fwd(model, qat, calib[0]) - float_hm) ** 2))
    assert len(info["losses"]) == 24
    assert info["losses"][-1] < info["losses"][0] * 1.05
    assert qat_err < ptq_err, (qat_err, ptq_err)


def test_fake_quant_runner_refuses_subpixel_deconvs(r18):
    run = tqat._FakeQuantRunner(tqat.FoldedParams(r18.folded, "cpu"), r18.scales)
    with pytest.raises(ValueError, match="PTQ-only"):
        run.qchain(torch.zeros(1, 4, 4, 512), None, "deconv0", subpixel=True)
