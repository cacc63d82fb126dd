"""The port's adversarial train step (train/gan.py) against the JAX
package's, from one carried state: the ResNet-18 MultiViewPose with the bank
(64x64 images, 16x16 heatmaps, three four-view groups, two of them h36m),
the five critics, MSE + consistency + fundamental + local, domain, heatmap,
view and joints MI, the grad-norm probe. The JAX step's draws are replayed
from its key chain (``kd, kg = split(key)``, ``split(kd, 8)``,
``fold_in(keys[i], view)``) through posetpu.core.mi's samplers and fed to
both steps.

- f32, each parity from the carried state: the metrics' keys JAX's, every
  metric within rtol 1e-5 but those :data:`LOOSER` and :data:`PROBES` name
  (1e-4, 1e-3; each with its measured distance and cause), the parameters
  of the base and of every critic by tests/test_torch_train.py's rule for
  one step (within 2 lr, and within 1e-6 on all but 2 % of a leaf's
  elements: Adam's first step turns a sign flip of a gradient at rounding
  level into 2 lr), every Adam count advanced (also those of critics with
  no loss at this parity), the critics' running statistics unchanged;
- (in float64: tests/test_torch_gan_f64.py, a file of its own so that
  xdist's --dist loadfile spreads the JAX compiles);
- the port's own draws (``draws=None``) at both parities: finite metrics.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.geometry import fundamental as jfund
from posetpu.data.synthetic import make_camera_ring as jax_camera_ring
from posetpu.models import MultiViewPose as JMultiView
from posetpu.models import get_pose_net as jax_pose_net
from posetpu.ops import heatmap as jhm
from posetpu.train import gan as jgan
from posetpu.train import optim as joptim
from posetpu.train.state import TrainState as JState
from posetpu_torch.models.convert import (
    from_jax_critic_variables,
    from_jax_train_states,
    from_jax_variables,
)
from posetpu_torch.models.discriminators import build_discriminators
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.train import gan as tgan
from posetpu_torch.train.optim import make_optimizer
from tests.test_torch_mi import (
    CRITICS,
    cfgs,
    jax_critic_variables,
    jax_heatmap_draws,
    jax_local_draws,
)
from tests.test_torch_serving_jns import np_variables

N = 3
LOSS = dict(USE_CONSISTENT_LOSS=True, USE_FUNDAMENTAL_LOSS=True, WATCH_GRAD_NORM=True)


def _batch(rng):
    """Three groups, the second not h36m; targets rendered from joints; the
    camera ring's F bank; the crop joints the MI samplers read."""
    joints = rng.uniform(4, 60, (N, 4, 16, 2)).astype(np.float32)
    vis = (rng.rand(N, 4, 16) > 0.2).astype(np.float32)
    target, weight = jhm.render_gaussian_heatmaps(joints, vis, (16, 16), (64, 64), sigma=2.0)
    bank = jfund.build_fundamental_bank({0: jax_camera_ring()})
    return {"images": rng.randn(N, 4, 64, 64, 3).astype(np.float32),
            "target": np.ascontiguousarray(np.moveaxis(np.asarray(target), 3, -1)),
            "weight": np.asarray(weight),
            "is_h36m": np.asarray([1.0, 0.0, 1.0], np.float32),
            "center": (500 + 20 * rng.randn(N, 4, 2)).astype(np.float32),
            "scale": (2 + rng.rand(N, 4, 2)).astype(np.float32),
            "fmats": np.asarray(jfund.bank_to_batch(bank, [0] * N)),
            "joints_crop": joints, "joints_vis": vis}


def jax_draws(key, batch, jcfg, parity):
    """The draws of the JAX step's key chain, in core/mi.sample_draws's
    layout."""
    kd, kg = jax.random.split(key)
    v = batch["joints_crop"].shape[1]
    jc, jv = batch["joints_crop"], batch["joints_vis"]
    out = {}
    for side, k, heatmap_parity in (("d", kd, 0), ("g", kg, 1)):
        keys = jax.random.split(k, 8)
        out[side] = {"local": [jax_local_draws(jax.random.fold_in(keys[0], i), jc[:, i],
                                               jv[:, i], jcfg)[0] for i in range(v)]}
        if parity == heatmap_parity:
            out[side]["heatmap"] = [
                jax_heatmap_draws(jax.random.fold_in(keys[1], i), jc[:, i], jv[:, i], jcfg,
                                  int(jcfg.HEATMAP_DISCRIMINATOR.JOINT_IDX)) for i in range(v)]
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).long(), out)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(rng, dtype=jnp.float32, **loss):
    """(JAX step, JAX states, port step factory, batch, configs, the port's
    optimizers) from one set of numpy weights."""
    jcfg, cfg = cfgs(**{**LOSS, **loss})
    for c in (jcfg, cfg):
        c.NETWORK.AGGRE = True
        c.LOCAL_DISCRIMINATOR.OUTPUT_CHANNELS = 256  # of 2048: the f64 step's time
    variables, batch = np_variables(rng), _batch(rng)
    defs, dvars = jax_critic_variables(jcfg, rng, dtype)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    jmodel = JMultiView(resnet=jax_pose_net(jcfg, dtype=dtype), aggre=True, dtype=dtype)
    jtx = joptim.make_optimizer(jcfg, 10)
    jtx_d = {n: joptim.make_optimizer(jcfg, 10, discriminator=True) for n in defs}
    states = {"base_model": JState(cast(variables["params"]), cast(variables["batch_stats"]),
                                   jtx.init(cast(variables["params"])), 0)}
    for n in defs:
        p = cast(dvars[n]["params"])
        states[n] = JState(p, cast(dvars[n].get("batch_stats", {})), jtx_d[n].init(p), 0)
    jstep = jgan.make_adversarial_train_step(jmodel, defs, jcfg, jtx, jtx_d)
    return jstep, states, batch, jcfg, cfg


def _port(cfg, jstates, tdtype=torch.float32):
    """The port's step and states carried from ``jstates``."""
    model = MultiViewPose(PoseResNet(num_layers=18, dtype=tdtype), heatmap_size=16,
                          dtype=tdtype).to(tdtype)
    ds = {n: m.to(tdtype) for n, m in build_discriminators(cfg).items()}
    tx = make_optimizer(cfg, 10)
    tx_d = {n: make_optimizer(cfg, 10, discriminator=True) for n in ds}
    states = from_jax_train_states(_np(jstates), {"base_model": model, **ds},
                                   {"base_model": tx, **tx_d}, device="cpu")
    return tgan.make_adversarial_train_step(model, ds, cfg, tx, tx_d, device="cpu"), states


def _convert(name, module, tree):
    if name == "base_model":
        return from_jax_variables(tree)
    return from_jax_critic_variables(tree, module)


def _compare_params(name, module, jstate, grads, lr):
    """tests/test_torch_train.py's one-step rule: within 2 lr (+1e-6), and
    within 1e-6 on all but 2 % of each leaf's elements. A leaf whose
    gradient is f32 rounding noise (its largest below 1e-5 of the model's:
    a bias before a BatchNorm, a LayerNorm shift an InfoNCE cancels) steps
    +-lr by the noise's sign in either framework: held to 2 lr alone."""
    ref = _convert(name, module, _np({"params": jstate.params}))
    gmax = max(float(g.abs().max()) for g in grads.values())
    for k, p in module.named_parameters():
        d = (p.detach().double() - ref[k].double()).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, (name, k, float(d.max()))
        if float(grads[k].abs().max()) > 1e-5 * gmax:
            assert float((d > 1e-6).double().mean()) <= 2e-2, (name, k)


def _jax_grads(name, module, jstate):
    """The first step's gradients from Adam's first moment: (1 - b1) g."""
    mu = next(s for s in jstate.opt_state if hasattr(s, "mu")).mu
    return _convert(name, module, _np({"params": jax.tree.map(lambda a: a / (1 - 0.9), mu)}))


# f32 metrics held to rtol 1e-4 (the others to 1e-5), with the largest
# distance measured: the terms on the soft-argmax joints (the fundamental
# term's reason; jmi 3.3e-5, vmi 3.2e-5), and the generator's terms scored by
# critics this step updated, whose weights differ by the one-step rule above
# (local_mi_g and with it the loss: 8.8e-6 here, 4.3e-5 with the local
# critic at its full 2048 channels)
LOOSER = ("fund_loss", "vmi_d", "vmi_g", "jmi_d", "jmi_g", "local_mi_g", "domain_g", "loss")
# and to 1e-3: the probe's gradient norms through the soft-argmax and
# through the heatmap critic's BatchNorm backward over 140k pairs, both in
# f32 (jmi 1.1e-4, vmi 6.1e-5; hmi 2.3e-6 here, 2.2e-4 on other weights;
# under 2e-6 in f64)
PROBES = ("grad_norm_fund", "grad_norm_hmi_g", "grad_norm_vmi_g", "grad_norm_jmi_g")


@pytest.mark.parametrize("parity", [0, 1])
def test_adversarial_step_matches_jax_from_one_carried_state(rng, parity):
    jstep, jstates, batch, jcfg, cfg = _setup(rng)
    key = jax.random.PRNGKey(3)
    new_j, jm = jstep(jstates, jax.tree.map(jnp.asarray, batch), key, epoch_parity=parity)
    step, states = _port(cfg, jstates)
    stats = {n: {k: v.clone() for k, v in st.batch_stats.items()}
             for n, st in states.items() if n != "base_model"}
    new, m = step(states, copy.deepcopy(batch), parity, draws=jax_draws(key, batch, jcfg, parity))

    assert set(m) == set(jm)
    assert {"hmi_d", "vmi_d", "jmi_d"} <= set(m) if parity == 0 else {"hmi_g", "vmi_g",
                                                                         "jmi_g"} <= set(m)
    for k in jm:
        rtol = 1e-3 if k in PROBES else 1e-4 if k in LOOSER else 1e-5
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, rtol=rtol)
    for n, st in new.items():
        assert st.step == int(new_j[n].step) == 1 and st.opt_state["count"] == 1, n
        lr = cfg.TRAIN.LR_DISCRIMINATOR if n in CRITICS else cfg.TRAIN.LR
        _compare_params(n, st.params, new_j[n], _jax_grads(n, st.params, new_j[n]), lr)
        if n in CRITICS:  # the critics normalise by batch statistics only
            for k, v in st.batch_stats.items():
                assert torch.equal(v, stats[n][k]), (n, k)


def test_adversarial_step_draws_its_own(rng):
    """draws=None: the step draws from its generator at both parities;
    every metric finite, every count advanced."""
    _, cfg = cfgs(**LOSS)
    cfg.NETWORK.AGGRE = True
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    ds = build_discriminators(cfg, torch.Generator().manual_seed(0))
    tx = make_optimizer(cfg, 10)
    tx_d = {n: make_optimizer(cfg, 10, discriminator=True) for n in ds}
    states = {"base_model": tgan.TrainState(model, tx.init(model), 0),
              **tgan.init_discriminator_states(ds, tx_d, device="cpu")}
    step = tgan.make_adversarial_train_step(model, ds, cfg, tx, tx_d, device="cpu", seed=1)
    batch = _batch(rng)
    for parity in (0, 1):
        states, m = step(states, batch, parity)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert all(st.step == 2 and st.opt_state["count"] == 2 for st in states.values())
    with pytest.raises(ValueError, match="parity"):
        step(states, batch, 2)
