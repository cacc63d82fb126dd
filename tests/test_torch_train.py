"""The port's supervised training step against the JAX package's, on the
same numpy inputs and weights (ResNet-18, 64x64 images, 16x16 heatmaps, two
four-view groups, the bank), the state carried across with
models/convert.from_jax_train_state.

- each loss, PCK, the Gaussian targets, the soft-argmax, the affine warp
  and the camera-exact F bank against JAX's functions (tolerances stated per
  test; the float losses reduce in another order);
- the MultiStep schedule (with and without warmup) at its boundaries, and
  Adam (f32 and bf16 first moment) and SGD over three steps: equal to optax
  bit for bit;
- ``FIX_BACKBONE``: the backbone bit-unchanged, the bank trained;
- one and three ``train_step`` from one carried state in f32 (MSE +
  consistency + fundamental, the grad-norm probe): the loss and its terms,
  PCK, ``batch_stats`` (Flax's biased-variance update) and the parameters.
  After one step the f32 gradients of the two frameworks differ by their
  rounding (amplified through train-mode BN on 128 values a channel at
  deconv0: up to a few % of a leaf's largest gradient), and Adam's first
  step ``lr * g / (|g| + eps)`` turns a sign flip of a gradient that small
  into a 2 lr difference: bounded so, on at most 2 % of a leaf. Over three steps
  those differences feed back, so the three-step bounds are looser;
- the same step in float64 (JAX under x64): gradients and the trajectory of
  three steps, as tests/test_torch_oracle_full.py holds the forward's
  gradients; and the fundamental term's gradient with respect to the
  heatmaps, in float64 end to end;
- ``make_eval_step`` with the in-batch flip test;
- a checkpoint round trip, synchronous and asynchronous.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posetpu.config import default_config as jax_config
from posetpu.core import evaluate as jev
from posetpu.core import losses as jl
from posetpu.data.synthetic import make_camera_ring as jax_camera_ring
from posetpu.geometry import fundamental as jfund
from posetpu.models import MultiViewPose as JMultiView
from posetpu.models import get_pose_net as jax_pose_net
from posetpu.ops import heatmap as jhm
from posetpu.ops import warp as jwarp
from posetpu.train import optim as joptim
from posetpu.train import step as jstep
from posetpu.train.state import TrainState as JState
from posetpu_torch.config import default_config
from posetpu_torch.core import evaluate as tev
from posetpu_torch.core import losses as tl
from posetpu_torch.data.synthetic import make_camera_ring
from posetpu_torch.geometry import fundamental as tfund
from posetpu_torch.models.convert import from_jax_train_state, from_jax_variables
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.ops import heatmap as thm
from posetpu_torch.ops import warp as twarp
from posetpu_torch.train import step as tstep
from posetpu_torch.train.checkpoint import CheckpointManager
from posetpu_torch.train.optim import make_optimizer, multistep_lr
from tests.test_torch_serving_jns import np_variables

N = 2
FLIP_PAIRS = [(0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)]


def _cfgs(**loss):
    out = []
    for make in (jax_config, default_config):
        c = make()
        c.NETWORK.IMAGE_SIZE = np.array([64, 64])
        c.NETWORK.HEATMAP_SIZE = np.array([16, 16])
        c.POSE_RESNET.NUM_LAYERS = 18
        c.NETWORK.AGGRE = True
        c.TRAIN.LR = 1e-4
        for k, v in loss.items():
            setattr(c.LOSS, k, v)
        out.append(c)
    return out


def _batch(rng):
    """Two groups, the second not h36m; targets rendered from joints; the
    camera ring's F bank."""
    joints = rng.uniform(4, 60, (N, 4, 16, 2)).astype(np.float32)
    target, weight = jhm.render_gaussian_heatmaps(joints, np.ones((N, 4, 16)), (16, 16),
                                                  (64, 64), sigma=2.0)
    bank = jfund.build_fundamental_bank({0: jax_camera_ring()})
    return {"images": rng.randn(N, 4, 64, 64, 3).astype(np.float32),
            "target": np.ascontiguousarray(np.moveaxis(np.asarray(target), 3, -1)),
            "weight": np.asarray(weight) * (rng.rand(N, 4, 16) > 0.2),
            "is_h36m": np.asarray([1.0, 0.0], np.float32),
            "center": (500 + 20 * rng.randn(N, 4, 2)).astype(np.float32),
            "scale": (2 + rng.rand(N, 4, 2)).astype(np.float32),
            "fmats": np.asarray(jfund.bank_to_batch(bank, [0] * N))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(dtype=torch.float32):
    return MultiViewPose(PoseResNet(num_layers=18, dtype=dtype), heatmap_size=16, dtype=dtype)


def _compare_state(st, jstate, param_atol, frac, stats_rtol):
    """Parameters within ``param_atol`` everywhere and within 1e-6 on all
    but ``frac`` of each leaf's elements; BN statistics within
    ``stats_rtol``."""
    ref = from_jax_variables(_np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    sd = st.params.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        got = sd[k].double()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, r.double(), rtol=stats_rtol, atol=stats_rtol,
                                       err_msg=k)
        else:
            d = (got - r.double()).abs()
            assert float(d.max()) <= param_atol, (k, float(d.max()))
            share = float((d > 1e-6).double().mean())
            assert share <= frac, (k, share)


# ---------------------------------------------------------------- functions


def test_losses_match_jax(rng):
    """Sums of ~2e4 f32 values in another order: within 1e-5."""
    out = rng.rand(N, 4, 16, 16, 16).astype(np.float32)
    tgt = rng.rand(N, 4, 16, 16, 16).astype(np.float32)
    w = (rng.rand(N, 4, 16) > 0.3).astype(np.float32)
    mask = np.asarray([1.0, 0.0], np.float32)
    t = torch.from_numpy
    for tw in (None, w):
        np.testing.assert_allclose(
            float(tl.joints_mse_loss(t(out), t(tgt), None if tw is None else t(tw))),
            float(jl.joints_mse_loss(out, tgt, tw)), rtol=1e-5)
    for m in (None, mask):
        np.testing.assert_allclose(
            float(tl.consistency_loss(t(out), t(tgt), None if m is None else t(m))),
            float(jl.consistency_loss(out, tgt, m)), rtol=1e-5)
    j2d = (500 + 100 * rng.randn(N, 4, 16, 2)).astype(np.float32)
    fm = rng.randn(N, 12, 3, 3).astype(np.float32)
    for use_tw in (True, False):
        np.testing.assert_allclose(
            float(tl.fundamental_loss(t(j2d), t(w), t(fm), t(mask), use_tw)),
            float(jl.fundamental_loss(*map(jnp.asarray, (j2d, w, fm, mask)), use_tw)),
            rtol=1e-5)
    assert tl.VIEW_PERMS == jl.VIEW_PERMS


def test_pck_accuracy_matches_jax(rng):
    gt_joints = rng.uniform(-2, 17, (6, 16, 2)).astype(np.float32)  # some invalid
    gt_joints[:, 3] = -5.0  # a joint with no valid GT: -1
    gt = jhm.render_gaussian_heatmaps(gt_joints * 4, np.ones((6, 16)), (16, 16), (64, 64),
                                      sigma=2.0)[0]
    pred = np.asarray(gt) + 0.3 * rng.rand(6, 16, 16, 16).astype(np.float32)
    ref = jev.pck_accuracy(pred, gt)
    got = tev.pck_accuracy(torch.from_numpy(pred), torch.from_numpy(np.asarray(gt)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert 0 < float(got[1]) < 1 and (got[0] == -1).any()


def test_gaussian_targets_and_soft_argmax_match_jax(rng):
    joints = rng.uniform(-30, 290, (3, 16, 2)).astype(np.float32)  # some off the map
    vis = (rng.rand(3, 16) > 0.2).astype(np.float32)
    ref_t, ref_w = jhm.render_gaussian_heatmaps(joints, vis, (64, 48), (256, 192), sigma=2.0)
    got_t, got_w = thm.render_gaussian_heatmaps(torch.from_numpy(joints),
                                                torch.from_numpy(vis), (64, 48), (256, 192), 2.0)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-6, atol=1e-7)
    assert 0 < float(got_w.mean()) < 1

    hm = rng.rand(3, 16, 48, 64).astype(np.float32) * 0.2
    np.testing.assert_allclose(thm.soft_argmax_2d(torch.from_numpy(hm)).numpy(),
                               np.asarray(jhm.soft_argmax_2d(hm)), rtol=1e-5, atol=1e-4)


def test_affine_warp_matches_jax(rng):
    from posetpu.ops.affine import get_affine_transform

    img = rng.rand(40, 50, 3).astype(np.float32)
    inv = np.asarray(get_affine_transform(np.array([25.0, 18.0]), np.array([0.2, 0.2]),
                                          17.0, (32, 24), inv=True))
    ref = np.asarray(jwarp.affine_warp_image(img, inv, (32, 24)))
    got = twarp.affine_warp_image(torch.from_numpy(img), torch.from_numpy(inv), (32, 24))
    assert got.shape == (24, 32, 3) and float(got.std()) > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    x, y = rng.uniform(-3, 52, (2, 7, 5)).astype(np.float32)  # past the border: zeros
    np.testing.assert_allclose(
        twarp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                              torch.from_numpy(y)).numpy(),
        np.asarray(jwarp.bilinear_sample(img, x, y)), rtol=1e-5, atol=1e-6)


def test_fundamental_bank_matches_jax():
    """float64 on the host from the same f32 cameras: equal to rounding."""
    ref = jfund.build_fundamental_bank({0: jax_camera_ring(), 3: jax_camera_ring(seed=1)})
    got = tfund.build_fundamental_bank({0: make_camera_ring(), 3: make_camera_ring(seed=1)})
    assert set(got) == set(ref) and len(got) == 24
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=str(k))
    np.testing.assert_array_equal(tfund.bank_to_batch(got, [3, 0, 3]).numpy(),
                                  np.asarray(jfund.bank_to_batch(got, [3, 0, 3])))


# ------------------------------------------------------------- the optimizer


@pytest.mark.parametrize("warmup", [0, 1])
def test_multistep_lr_matches_optax_at_its_boundaries(warmup):
    ref = joptim.multistep_lr(1e-3, [2, 3], 0.1, steps_per_epoch=5, warmup_epochs=warmup)
    got = multistep_lr(1e-3, [2, 3], 0.1, steps_per_epoch=5, warmup_epochs=warmup)
    w = 5 * warmup
    for step in [0, 1, 2, 3, 4, w, w + 1] + [w + b + d for b in (10, 15) for d in (-1, 0, 1)]:
        assert got(step) == np.float32(ref(jnp.int32(step))), step


@pytest.mark.parametrize("kind", ["adam", "adam_mu_bf16", "sgd", "sgd_nesterov"])
def test_optimizer_matches_optax(rng, kind):
    """Three steps across a schedule boundary, gradients over 9 decades:
    parameters (and Adam's first moment) equal bit for bit."""
    cfgs = _cfgs()
    for c in cfgs:
        c.TRAIN.OPTIMIZER = "sgd" if kind.startswith("sgd") else "adam"
        c.TRAIN.NESTEROV = kind == "sgd_nesterov"
        c.TRAIN.ADAM_MU_DTYPE = "bfloat16" if kind == "adam_mu_bf16" else "float32"
        c.TRAIN.LR_STEP = [1]
    jtx, tx = joptim.make_optimizer(cfgs[0], 2), make_optimizer(cfgs[1], 2)
    p0 = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    jp = jax.tree.map(jnp.asarray, p0)
    js, st = jtx.init(jp), tx.init(module)
    for _ in range(3):
        g = {k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-9, 0, v.shape)).astype(np.float32)
             for k, v in p0.items()}
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        tx.update(module, st)
        for k, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp[k]), err_msg=k)
    if kind.startswith("adam"):
        assert st["mu"]["a"].dtype == (torch.bfloat16 if kind == "adam_mu_bf16"
                                       else torch.float32)
        for k in p0:
            np.testing.assert_array_equal(st["mu"][k].float().numpy(),
                                          np.asarray(js[0].mu[k], np.float32))


def test_fix_backbone_trains_only_the_bank(rng):
    _, cfg = _cfgs()
    cfg.TRAIN.FIX_BACKBONE = True
    model = _port_model()
    model.load_state_dict(from_jax_variables(np_variables(rng)))
    tx = make_optimizer(cfg, 10)
    state = tstep.init_train_state(model, tx, device="cpu")
    assert set(state.opt_state["mu"]) == {"aggre_layer.weight"}
    before = {k: v.clone() for k, v in model.named_parameters()}
    state, _ = tstep.make_train_step(model, cfg, tx, device="cpu")(state, _batch(rng))
    for k, v in model.named_parameters():
        if k == "aggre_layer.weight":
            assert not torch.equal(v, before[k])
        else:
            assert torch.equal(v, before[k]), k


# ------------------------------------------------------------ the train step


def test_train_step_matches_jax_from_one_carried_state(rng):
    loss = dict(USE_CONSISTENT_LOSS=True, USE_FUNDAMENTAL_LOSS=True, WATCH_GRAD_NORM=True)
    jcfg, cfg = _cfgs(**loss)
    variables, batch = np_variables(rng), _batch(rng)
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=True)
    jtx = joptim.make_optimizer(jcfg, 10)
    jtrain = jstep.make_train_step(jmodel, jcfg, jtx)
    jstate = JState(variables["params"], variables["batch_stats"],
                    jtx.init(variables["params"]), 0)
    jb = jax.tree.map(jnp.asarray, batch)

    tx = make_optimizer(cfg, 10)
    state = from_jax_train_state(_np(jstate), _port_model(), tx, device="cpu")
    train = tstep.make_train_step(state.params, cfg, tx, device="cpu")
    keys = ("loss", "mse_loss", "consistent_loss", "fund_loss", "acc", "grad_norm_mse",
            "grad_norm_consistent", "grad_norm_fund")
    for i in range(3):
        jstate, jm = jtrain(jstate, jb)
        state, m = train(state, batch)
        assert set(m) == set(keys) and state.step == int(jstate.step) == i + 1
        got, ref = {k: float(m[k]) for k in keys}, {k: float(jm[k]) for k in keys}
        if i == 0:  # the same state in: the rounding of the two frameworks apart
            for k in keys:  # the fundamental term's soft-argmax scales maps by 100
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4 if "fund" in k else 1e-5,
                                           err_msg=k)
            _compare_state(state, jstate, param_atol=2 * cfg.TRAIN.LR + 1e-6, frac=2e-2,
                           stats_rtol=1e-5)
        assert all(np.isfinite(v) for v in got.values())
    # three steps: each run's first-step differences fed back twice
    for k in ("loss", "mse_loss", "consistent_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(got["fund_loss"], ref["fund_loss"], rtol=3e-2)
    assert state.opt_state["count"] == 3
    _compare_state(state, jstate, param_atol=6 * cfg.TRAIN.LR, frac=1.0, stats_rtol=1e-2)


def _f64_step_setup(rng, **loss):
    jcfg, cfg = _cfgs(**loss)
    for c in (jcfg, cfg):
        c.TRAIN.LR = 1e-3
    return jcfg, cfg, np_variables(rng), _batch(rng)


def test_train_step_f64_gradients_and_trajectory_match_jax(rng):
    """float64 on both sides (MSE + consistency): the gradients (Adam's
    first moment after one step from zero is (1 - b1) g) within 1e-6 of the
    largest of each leaf (7.6e-7 measured: the heatmaps leave the model in
    f32 in both packages and the consistency term is taken there, so that
    is f32's rounding, not f64's), the BN statistics within 1e-12, the
    first step's losses within 1e-6 and the next two's within 2e-4 (7.2e-5
    measured: Adam flips the sign of the gradients at that noise)."""
    jcfg, cfg, variables, batch = _f64_step_setup(rng, USE_CONSISTENT_LOSS=True)
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jmodel = JMultiView(resnet=jax_pose_net(jcfg, dtype=jnp.float64), aggre=True,
                            dtype=jnp.float64)
        jtx = joptim.make_optimizer(jcfg, 10)
        jtrain = jstep.make_train_step(jmodel, jcfg, jtx)
        jstate = JState(v64["params"], v64["batch_stats"], jtx.init(v64["params"]), 0)
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        jstates, jms = [], []
        for _ in range(3):
            jstate, jm = jtrain(jstate, jb)
            jstates.append(_np(jstate))
            jms.append({k: float(v) for k, v in jm.items()})
    tx = make_optimizer(cfg, 10)
    model = _port_model(torch.float64).double()
    state = from_jax_train_state(_np(JState(v64["params"], v64["batch_stats"],
                                            jtx.init(v64["params"]), 0)), model, tx, "cpu")
    train = tstep.make_train_step(model, cfg, tx, device="cpu")
    b64 = {k: np.asarray(v, np.float64) for k, v in batch.items()}
    for i in range(3):
        state, m = train(state, b64)
        for k in ("loss", "mse_loss", "consistent_loss"):
            np.testing.assert_allclose(float(m[k]), jms[i][k], rtol=1e-6 if i == 0 else 2e-4,
                                       err_msg=k)
        if i == 0:
            g = from_jax_variables({"params": jstates[0].opt_state[0].mu})
            worst = max(float((p.grad - g[k] / (1 - 0.9)).abs().max() / g[k].abs().max())
                        for k, p in model.named_parameters())
            assert worst < 1e-6, worst
            ref = from_jax_variables({"params": {}, "batch_stats": jstates[0].batch_stats})
            for k, r in ref.items():
                if "running" in k:
                    np.testing.assert_allclose(model.state_dict()[k], r, rtol=1e-12,
                                               atol=1e-14, err_msg=k)


def test_fundamental_term_gradient_f64_matches_jax(rng):
    """The fundamental term (soft-argmax, inverse affine, the epipolar
    residual, the h36m rescale) as a function of the routed heatmaps, in
    float64 end to end: value and gradient within 1e-10."""
    _, cfg = _cfgs(USE_FUNDAMENTAL_LOSS=True)
    batch = _batch(rng)
    out = rng.rand(N, 4, 16, 16, 16) * 0.05

    def jax_term(o):
        b = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        j2d = jstep._integral_joints_image_coords(o, b["center"], b["scale"], (16, 16))
        fl = jl.fundamental_loss(j2d, b["weight"], b["fmats"], sample_mask=b["is_h36m"])
        return fl * (N / jnp.maximum(jnp.sum(b["is_h36m"]), 1.0))

    with jax.enable_x64():
        # JAX's affine_transform_points casts the points to f32: keep them f64
        # there as the port does on f64 maps
        orig = jstep.affine_transform_points
        jstep.affine_transform_points = lambda p, t: (
            jnp.einsum("...ij,...kj->...ki", t[..., :2, :2].astype(p.dtype), p)
            + t[..., None, :2, 2].astype(p.dtype))
        try:
            ref_v, ref_g = jax.jit(jax.value_and_grad(jax_term))(jnp.asarray(out))
        finally:
            jstep.affine_transform_points = orig
    o = torch.tensor(out, requires_grad=True)
    j2d = tstep._integral_joints_image_coords(o, torch.from_numpy(batch["center"]),
                                              torch.from_numpy(batch["scale"]), (16, 16))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    fl = tl.fundamental_loss(j2d, tb["weight"].double(), tb["fmats"].double(),
                             sample_mask=tb["is_h36m"].double())
    v = fl * (N / torch.clamp(tb["is_h36m"].sum(), min=1.0))
    v.backward()
    np.testing.assert_allclose(float(v), float(ref_v), rtol=1e-10)
    g, r = o.grad.numpy(), np.asarray(ref_g)
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-10 * np.abs(r).max())


def test_eval_step_with_flip_matches_jax(rng):
    jcfg, cfg = _cfgs(USE_CONSISTENT_LOSS=True)
    for c in (jcfg, cfg):
        c.TEST.FLIP_TEST = True
        c.TEST.SHIFT_HEATMAP = True
        c.TEST.POST_PROCESS = True
    variables, batch = np_variables(rng), _batch(rng)
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=True)
    ref = jstep.make_eval_step(jmodel, jcfg, flip_pairs=FLIP_PAIRS)(
        variables, jax.tree.map(jnp.asarray, batch))
    model = _port_model()
    model.load_state_dict(from_jax_variables(_np(variables)))
    got = tstep.make_eval_step(model, cfg, flip_pairs=FLIP_PAIRS, device="cpu")(model, batch)
    assert set(got) == set(ref) and not model.training
    hm = np.asarray(ref["heatmaps"])  # f32 convs sum in another order: 1e-5 of the range
    np.testing.assert_allclose(got["heatmaps"].numpy(), hm, rtol=0,
                               atol=1e-5 * (hm.max() - hm.min()))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(ref["acc"]), rtol=1e-6)
    maxvals = np.asarray(ref["maxvals"])
    np.testing.assert_allclose(got["maxvals"].numpy(), maxvals, rtol=1e-4,
                               atol=1e-5 * (hm.max() - hm.min()))
    # where a map's maximum is > 0 the joints decode alike (a near-tie may
    # move a peak); where it is <= 0 the port decodes (0, 0) with no nudge,
    # as B7 and the reference do (JAX's channels-last decode nudges it)
    pos = maxvals > 0
    same = np.abs(got["preds"].numpy() - np.asarray(ref["preds"])).max(-1) <= 1e-3
    assert 0 < pos.mean() < 1 and same[pos].mean() >= 0.95, (pos.mean(), same[pos].mean())
    origin = tstep.final_preds(torch.zeros(N, 4, 16, 16, 16), torch.from_numpy(
        batch["center"]), torch.from_numpy(batch["scale"]))[0]
    assert torch.equal(got["preds"][torch.from_numpy(~pos)], origin[torch.from_numpy(~pos)])


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip(rng, tmp_path, async_save):
    _, cfg = _cfgs()
    model = _port_model()
    tx = make_optimizer(cfg, 10)
    state = tstep.init_train_state(model, tx, device="cpu")
    state, _ = tstep.make_train_step(model, cfg, tx, device="cpu")(state, _batch(rng))
    ckpt = CheckpointManager(str(tmp_path), async_save=async_save)
    ckpt.save_epoch(1, {"model": state}, perf=0.5, is_best=True)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
    with torch.no_grad():  # the live state moves on while the save is in flight
        for p in model.parameters():
            p.add_(1.0)
    assert ckpt.exists("checkpoint") and ckpt.exists("model_best")

    fresh = tstep.init_train_state(_port_model(), tx, device="cpu")
    restored, meta = ckpt.restore("checkpoint", template={"model": fresh})
    assert meta == {"epoch": 1, "perf": 0.5} and restored["model"] is fresh
    assert fresh.step == 1 and fresh.opt_state["count"] == 1
    for k, v in fresh.params.state_dict().items():
        assert torch.equal(v, snapshot[k]), k
    for k, v in fresh.opt_state["mu"].items():
        assert torch.equal(v, mu[k]), k
    only = ckpt.restore_model("model_best")
    assert set(only["model"]) == {"params", "batch_stats"}
    assert torch.equal(only["model"]["batch_stats"]["resnet.bn1.running_var"],
                       snapshot["resnet.bn1.running_var"])
    ckpt.save_final({"model": dataclasses.replace(fresh, step=7)})
    assert ckpt.restore("final_state")[0]["model"]["step"] == 7


# ------------------------------------------- refused restores, absent gradients


def _small_state(extra=False, bias=True):
    """A TrainState of a Linear + BatchNorm module (Adam), optionally with
    one leaf more or its Linear bias removed."""
    _, cfg = _cfgs()
    module = torch.nn.Sequential(torch.nn.Linear(3, 4, bias=bias), torch.nn.BatchNorm1d(4))
    if extra:
        module.register_parameter("extra", torch.nn.Parameter(torch.zeros(2)))
    tx = make_optimizer(cfg, 10)
    return tstep.TrainState(module, tx.init(module), 0)


def test_checkpoint_refuses_a_mismatched_template(tmp_path):
    """A restore into a template with one leaf more, or one parameter
    fewer, is refused with the keys named (the JAX package's orbax restore
    refuses both, also with ValueError); a matching one restores."""
    from posetpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from posetpu.train.state import TrainState as JTrainState

    ckpt = CheckpointManager(str(tmp_path / "port"))
    ckpt.save("checkpoint", {"model": _small_state()})
    with pytest.raises(ValueError, match=r"missing keys \['extra'\]"):
        ckpt.restore("checkpoint", template={"model": _small_state(extra=True)})
    with pytest.raises(ValueError, match=r"unexpected keys \['0.bias'\]"):
        ckpt.restore("checkpoint", template={"model": _small_state(bias=False)})
    ckpt.restore("checkpoint", template={"model": _small_state()})

    jckpt = JCheckpointManager(str(tmp_path / "jax"))
    leaves = {"w": jnp.ones(3), "b": jnp.zeros(2)}
    jckpt.save("checkpoint", {"model": JTrainState(leaves, {}, {"mu": jnp.zeros(3)}, 0)})
    jckpt.wait_until_finished()
    for template in ({**leaves, "extra": jnp.zeros(1)}, {"w": leaves["w"]}):
        with pytest.raises(ValueError, match="do not match"):
            jckpt.restore("checkpoint", {"model": JTrainState(template, {}, {"mu": jnp.zeros(3)},
                                                              0)})


def test_checkpoint_round_trip_of_the_adversarial_states(rng, tmp_path):
    """The six states of the adversarial step (the base model and five
    critics, their weights, statistics and Adam moments filled with random
    values, count and step 3) saved and restored into fresh templates: every
    tensor, moment, count and step equal."""
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.train import gan as tgan
    from tests.test_torch_mi import cfgs as mi_cfgs

    _, cfg = mi_cfgs()

    def states_of(seed):
        model = _port_model()
        ds = build_discriminators(cfg, torch.Generator().manual_seed(seed))
        tx = make_optimizer(cfg, 10)
        tx_d = {n: make_optimizer(cfg, 10, discriminator=True) for n in ds}
        return {"base_model": tstep.init_train_state(model, tx, device="cpu"),
                **tgan.init_discriminator_states(ds, tx_d, device="cpu")}

    states = states_of(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for st in states.values():
            for t in [*st.params.state_dict().values(), *st.opt_state["mu"].values(),
                      *st.opt_state["nu"].values()]:
                if t.is_floating_point():
                    t.copy_(torch.rand(t.shape, generator=gen))
            st.opt_state["count"], st.step = 3, 3
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("checkpoint", states)
    restored, _ = ckpt.restore("checkpoint", template=states_of(2))
    assert len(restored) == 6
    for name, st in states.items():
        got = restored[name]
        assert got.step == 3 and got.opt_state["count"] == 3, name
        for k, v in st.params.state_dict().items():
            assert torch.equal(got.params.state_dict()[k], v), (name, k)
        for m in ("mu", "nu"):
            for k, v in st.opt_state[m].items():
                assert torch.equal(got.opt_state[m][k], v), (name, m, k)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_steps_an_absent_gradient_as_optax_steps_zeros(rng, kind):
    """One parameter has a gradient at step 1 and none (``.grad`` None) at
    step 2: optax, given zeros there, still advances the moments and moves
    the parameter by the first moment; the port equal to it bit for bit."""
    cfgs = _cfgs()
    for c in cfgs:
        c.TRAIN.OPTIMIZER = kind
    jtx, tx = joptim.make_optimizer(cfgs[0], 2), make_optimizer(cfgs[1], 2)
    p0 = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    jp = jax.tree.map(jnp.asarray, p0)
    js, st = jtx.init(jp), tx.init(module)
    for i in range(2):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        if i == 1:
            g["b"] = np.zeros_like(g["b"])
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        module.a.grad = torch.from_numpy(g["a"])
        module.b.grad = torch.from_numpy(g["b"]) if i == 0 else None
        b_before = module.b.detach().clone()
        tx.update(module, st)
        for k, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp[k]), err_msg=k)
    assert not torch.equal(module.b, b_before)  # b moved at step 2 too
    moments = ("mu", "nu") if kind == "adam" else ("trace",)
    jstate = js[0]
    for m in moments:
        for k in p0:
            ref = getattr(jstate, m)[k]
            np.testing.assert_array_equal(st[m][k].numpy(), np.asarray(ref), err_msg=(m, k))
    assert st["count"] == 2


def test_train_step_without_a_bank_gradient_matches_optax(rng):
    """The bank, with the fused output unused (TEST.FUSE_OUTPUT off, no
    consistency or fundamental loss), gets no gradient: two train steps
    against JAX's, whose optax steps zeros for it. The loss as JAX's, the
    bank, its moments and the count equal to optax's bit for bit, the other
    parameters by the one-step rule."""
    jcfg, cfg = _cfgs()
    for c in (jcfg, cfg):
        c.TEST.FUSE_OUTPUT = False
    variables, batch = np_variables(rng), _batch(rng)
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=True)
    jtx = joptim.make_optimizer(jcfg, 10)
    jtrain = jstep.make_train_step(jmodel, jcfg, jtx)
    jstate = JState(variables["params"], variables["batch_stats"],
                    jtx.init(variables["params"]), 0)
    tx = make_optimizer(cfg, 10)
    state = from_jax_train_state(_np(jstate), _port_model(), tx, device="cpu")
    train = tstep.make_train_step(state.params, cfg, tx, device="cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    for i in range(2):
        jstate, jm = jtrain(jstate, jb)
        state, m = train(state, batch)
        assert state.params.aggre_layer.weight.grad is None
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
            _compare_state(state, jstate, param_atol=2 * cfg.TRAIN.LR + 1e-6, frac=2e-2,
                           stats_rtol=1e-5)
    adam = next(s for s in jstate.opt_state if hasattr(s, "mu"))
    bank = "aggre_layer.weight"
    np.testing.assert_array_equal(state.params.aggre_layer.weight.detach().numpy(),
                                  np.asarray(jstate.params["aggre_layer"]["weight"]))
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(state.opt_state[m][bank].numpy(),
                                      np.asarray(getattr(adam, m)["aggre_layer"]["weight"]))
    assert state.opt_state["count"] == int(adam.count) == 2
