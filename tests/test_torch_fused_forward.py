"""posetpu_torch.models.quant.make_fused_forward against the JAX package's
(its Pallas kernels in interpret mode) and against the port's own runner
forward: ResNet-50, 64x64 input, 2 images, trained-like weights from a seed
carried by convert.from_jax_variables, the JAX side's params carried by
convert.from_jax_params. On the CPU the port's kernel wrappers run their
plain versions.

Tolerance, port vs JAX on the same params. The reference is JAX's forward
run op by op (``jax.disable_jit()``), each f32 operation rounded on its own
as the source writes it: the heatmaps are then equal except for the head's
f32 epilogue, which XLA on the CPU contracts into one FMA inside the
interpreted kernel (within one rounding of the product plus one of the
result, the bound tests/test_torch_phase_tail.py states). Every int8 stage before it (13 fused
blocks with ``pallas_blocks``, two fused deconvs, the runner's blocks) must
then be exact. Under ``jax.jit`` the same holds with ``pallas_blocks=True``.
With ``pallas_blocks=False`` XLA also contracts the runner's residual
epilogues: one int8 value of layer1_2's 131,072 outputs moves by one step,
and 13 more blocks of random weights spread that to heatmap differences of
up to 2.7 % of their range; the test holds the port to 5 % there and says so.

Port's fused forward vs the port's runner forward: the kernels' folded,
once-rounded epilogues may move an int8 value by one step on rare elements
(tests/test_pallas_resblock.py: < 1e-3 of a block's elements). Held stage by
stage on the runner's own activations (each fused block and deconv within
one step of the runner's, on a stated share), and end to end within 5 % of
the heatmaps' range with at least 90 % of the peaks in place."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.models import quant as jq
from posetpu_torch.models import quant as tq
from posetpu_torch.models.convert import from_jax_params
from posetpu_torch.ops import deconv as tdc
from posetpu_torch.ops import resblock as trb
from tests.test_quant import _trained_like_variables
from tests.test_torch_quant import _np_tree, _port_model, assert_head_rounding_only

FUSED_BLOCKS = (["layer1_0", "layer1_1", "layer1_2", "layer2_1", "layer2_2", "layer2_3"]
                + [f"layer3_{i}" for i in range(1, 6)] + ["layer4_1", "layer4_2"])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    jmodel, variables = _trained_like_variables(rng, num_layers=50)
    calib = [rng.randn(2, 64, 64, 3).astype(np.float32)]
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    qparams, _ = jq.quantize_pose_resnet(jmodel, variables, calib)
    return jmodel, qparams, _port_model(variables, 50), x


def _runner_forward(model, x):
    return tq.quantize_pose_resnet(
        model, [x], jns_head=False, stem_s2d=False, subpixel_deconvs=False,
        phase_kernel=False, device="cpu")[1]


@pytest.mark.parametrize("pallas_blocks", [False, True])
def test_fused_forward_matches_jax(setup, pallas_blocks):
    jmodel, qparams, model, x = setup
    jparams, jfwd = jq.make_fused_forward(jmodel, qparams, interpret=True,
                                          pallas_blocks=pallas_blocks)
    ref_jit = np.asarray(jfwd(jparams, jnp.asarray(x)))
    with jax.disable_jit():
        ref = np.asarray(jfwd(jparams, jnp.asarray(x)))

    carried = from_jax_params(_np_tree(jparams), "cpu")
    params, fwd = tq.make_fused_forward(model, carried["q"], pallas_blocks=pallas_blocks,
                                        device="cpu")
    assert sorted(params["fused"]) == sorted(FUSED_BLOCKS if pallas_blocks else [])
    assert len(params["deconv"]) == 3 and "wh" in params["deconv"][2]
    # the port's own argument packs equal the carried JAX ones
    for name, args in carried["fused"].items():
        for k, v in args.items():
            assert torch.equal(params["fused"][name][k], v), (name, k)
    for mine, theirs in zip(params["deconv"], carried["deconv"]):
        for k, v in theirs.items():
            assert torch.equal(mine[k], v), k

    got = fwd(params, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 16) and got.dtype == np.float32
    assert np.std(got) > 0
    vh = params["deconv"][2]["vh"]
    assert_head_rounding_only(got.transpose(3, 0, 1, 2), ref.transpose(3, 0, 1, 2), vh)
    if pallas_blocks:
        assert_head_rounding_only(got.transpose(3, 0, 1, 2),
                                  ref_jit.transpose(3, 0, 1, 2), vh)
    else:
        assert np.abs(got - ref_jit).max() <= 0.05 * float(ref.max() - ref.min())


class _Logging(tq._Int8Runner):
    """The runner, keeping each stage's int8 output by site name."""

    def __init__(self, q):
        super().__init__(q)
        self.log = {}

    def max_pool(self, h_q):
        self.log["pool"] = super().max_pool(h_q)
        return self.log["pool"]

    def block_out(self, m_q, s_m, conv, r_q, r_s, name):
        out = super().block_out(m_q, s_m, conv, r_q, r_s, name)
        self.log[name] = out[0]
        return out

    def qchain(self, h_q, s_h, name, **kw):
        out = super().qchain(h_q, s_h, name, **kw)
        self.log[f"{name}.out"] = out[0]
        return out


def test_fused_stages_within_one_step_of_the_runner(setup):
    """Each fused block and deconv on the runner's own activations."""
    _, qparams, model, x = setup
    q = from_jax_params({"q": _np_tree(qparams)}, "cpu")["q"]
    runner = _Logging(q)
    with torch.no_grad():
        ref_hm = tq._forward(runner, torch.from_numpy(x), 50, (4, 4, 4))
    params, _ = tq.make_fused_forward(model, q, pallas_blocks=True, device="cpu")
    names = ["pool"] + [f"{info['name']}.out" for kind, info in tq._plan(50, (4, 4, 4))
                        if kind == "block"] + [f"deconv{i}.out" for i in range(3)]

    def one_step(got, want, share):
        d = (got.reshape(want.shape).int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < share

    for name, args in params["fused"].items():
        x_in = runner.log[names[names.index(f"{name}.out") - 1]]
        n, hh, ww, c = x_in.shape
        one_step(trb.fused_bottleneck(x_in.reshape(n, hh * ww, c), args, h=hh, w=ww),
                 runner.log[f"{name}.out"], 1e-3)
    for i, args in enumerate(params["deconv"][:2]):
        x_in = runner.log[names[names.index(f"deconv{i}.out") - 1]]
        n, hh, ww, c = x_in.shape
        one_step(tdc.fused_subpixel_deconv(x_in.reshape(n, hh * ww, c), args, h=hh, w=ww),
                 runner.log[f"deconv{i}.out"], 1e-2)
    x_in = runner.log["deconv1.out"]
    n, hh, ww, c = x_in.shape
    hm = tdc.fused_subpixel_deconv_head(x_in.reshape(n, hh * ww, c), params["deconv"][2],
                                        h=hh, w=ww).reshape(ref_hm.shape)
    # a one-step move of a deconv2 value moves a heatmap value by |w| * scale
    step = 127.0 * float(params["deconv"][2]["vh"][0].max())
    assert float((hm - ref_hm).abs().max()) <= 4 * step
    assert float((hm != ref_hm).float().mean()) < 0.1


@pytest.mark.parametrize("pallas_blocks", [False, True])
def test_fused_forward_close_to_runner_forward(setup, pallas_blocks):
    _, qparams, model, x = setup
    q = from_jax_params({"q": _np_tree(qparams)}, "cpu")["q"]
    ref = _runner_forward(model, x)(q, torch.from_numpy(x)).numpy()
    params, fwd = tq.make_fused_forward(model, q, pallas_blocks=pallas_blocks, device="cpu")
    got = fwd(params, torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 0.05 * float(ref.max() - ref.min())
    peaks = lambda hm: hm.reshape(2, -1, 16).argmax(axis=1)
    assert (peaks(got) == peaks(ref)).mean() >= 0.9


def test_fused_forward_options(setup):
    """``pallas_deconvs=False`` keeps the deconvs and head on the runner's
    path (dilated int8 convs), where the forward equals the runner's bit for
    bit; an int8 input is taken as it is; the wrappers count no launch on
    the CPU."""
    _, qparams, model, x = setup
    q = from_jax_params({"q": _np_tree(qparams)}, "cpu")["q"]
    runner_fwd = _runner_forward(model, x)
    xt = torch.from_numpy(x)
    params, fwd = tq.make_fused_forward(model, q, pallas_deconvs=False, device="cpu")
    assert params["fused"] == {} and params["deconv"] == []
    assert torch.equal(fwd(params, xt), runner_fwd(q, xt))

    before = (trb.fused_bottleneck.launches, tdc.fused_subpixel_deconv.launches,
              tdc.fused_subpixel_deconv_head.launches)
    params, fwd = tq.make_fused_forward(model, q, pallas_blocks=True, device="cpu")
    xq = tq._Int8Runner(q).input(xt)[0]
    assert torch.equal(fwd(params, xq), fwd(params, xt))
    assert before == (trb.fused_bottleneck.launches, tdc.fused_subpixel_deconv.launches,
                      tdc.fused_subpixel_deconv_head.launches)
