"""The port's adversarial losses, samplers and critics against the JAX
package's, on the same numpy inputs and carried weights (small sizes: the
ResNet-18 configuration at 64x64 images and 16x16 maps, 2-4 samples).

- the measures (every f-divergence as one case), InfoNCE / JSD over paired
  embeddings and the BCE;
- the camera projections, the 8-point F and the reference bank's reader;
- the samplers: masked cells never drawn, no repeats without replacement,
  frequencies uniform over the unmasked cells, and the joint variant's masks
  equal to the ones the JAX package samples from;
- each critic's forward (training and eval mode) on weights carried across
  by models/convert.from_jax_critic_variables, and its running statistics
  untouched in training mode;
- each MI loss with the JAX package's own draws, replayed from its key
  chain through posetpu.core.mi's samplers and fed to both packages: value
  and input gradient (the local MI in its three pair layouts, the heatmap MI
  under NCE and JSD, view and joints MI, the domain GAN's two sides) and
  the gradient penalty's gradient with respect to the critic's weights.

f32 sums run in another order in the two frameworks: values within rtol
1e-5 and gradients within 1e-5 of their largest element unless a test says
otherwise.
"""

from __future__ import annotations

import pickle
from contextlib import contextmanager
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.config import default_config as jax_config
from posetpu.core import losses as jl
from posetpu.core import mi as jmi
from posetpu.data.synthetic import make_camera_ring as jax_camera_ring
from posetpu.data.synthetic import make_poses3d
from posetpu.geometry import cameras as jcam
from posetpu.geometry import fundamental as jfund
from posetpu.models.discriminators import build_discriminators as jax_discriminators
from posetpu_torch.config import default_config
from posetpu_torch.core import losses as tl
from posetpu_torch.core import mi as tmi
from posetpu_torch.data.synthetic import make_camera_ring
from posetpu_torch.geometry import cameras as tcam
from posetpu_torch.geometry import fundamental as tfund
from posetpu_torch.models.convert import from_jax_critic_variables
from posetpu_torch.models.discriminators import (
    BatchNorm,
    LocalDiscriminator,
    build_discriminators,
)

CRITICS = ("local_discriminator", "domain_discriminator", "view_discriminator",
           "joints_discriminator", "heatmap_discriminator")
LOW_C, HIGH_C = 64, 256  # ResNet-18's layer1 and deconv channels


def cfgs(**loss):
    """(JAX config, port config): ResNet-18, 64x64 images, 16x16 maps, the
    five adversarial losses on (the joint-specific local MI, JSD), and
    ``loss`` overrides."""
    out = []
    for make in (jax_config, default_config):
        c = make()
        c.NETWORK.IMAGE_SIZE = np.array([64, 64])
        c.NETWORK.HEATMAP_SIZE = np.array([16, 16])
        c.POSE_RESNET.NUM_LAYERS = 18
        c.TRAIN.LR = 1e-4
        c.LOSS.SPECIFIC = "joint"
        c.LOSS.MI_MEASURE = "JSD"
        for k in ("USE_LOCAL_MI_LOSS", "USE_DOMAIN_TRANSFER_LOSS", "USE_VIEW_MI_LOSS",
                  "USE_JOINTS_MI_LOSS", "USE_HEATMAP_MI_LOSS"):
            setattr(c.LOSS, k, True)
        for k, v in loss.items():
            setattr(c.LOSS, k, v)
        out.append(c)
    return out


def np_flax_variables(module, rng) -> dict:
    """Flax variables (numpy) for the JAX counterpart of a port critic:
    ``module``'s weights as built, biases and norm parameters and running
    statistics drawn away from their init, laid out as Flax's (the inverse
    of convert.from_jax_critic_variables), so no JAX init has to run."""
    params, stats = {}, {}
    owners = dict(module.named_modules())
    for key, t in module.state_dict().items():
        *path, leaf = key.split(".")
        owner = owners[".".join(path)]
        v = t.numpy()
        r = rng.randn(*v.shape).astype(np.float32)
        if leaf.startswith("running_"):
            tree, leaf = stats, leaf[len("running_"):]
            v = 0.1 * r if leaf == "mean" else 1.0 + 0.05 * np.abs(r)
        else:
            tree = params
            if isinstance(owner, (BatchNorm, torch.nn.LayerNorm)):
                v, leaf = (1.0 + 0.1 * r, "scale") if leaf == "weight" else (0.1 * r, "bias")
            elif leaf == "bias":
                v = 0.1 * r
            elif v.ndim == 4:  # OIHW -> HWIO
                v, leaf = v.transpose(2, 3, 1, 0), "kernel"
            elif path[-1].startswith("conv"):  # a Flax 1x1 conv, an nn.Linear here
                v, leaf = v.T[None, None], "kernel"
            else:  # Dense [I, O]
                v, leaf = v.T, "kernel"
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = np.ascontiguousarray(v, np.float32)
    return {"params": params, "batch_stats": stats}


def jax_critic_variables(jcfg, rng, dtype=jnp.float32):
    """(Flax critic modules in ``dtype``, {name: numpy variables}) for the
    critics ``jcfg`` enables: the port's init from a seeded generator, made
    Flax variables by :func:`np_flax_variables`."""
    gen = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    variables = {n: np_flax_variables(m, rng)
                 for n, m in build_discriminators(jcfg_port(jcfg), gen).items()}
    return jax_discriminators(jcfg, dtype=dtype), variables


def jcfg_port(jcfg):
    """The port's config with ``jcfg``'s network and critic sections."""
    c = default_config()
    for sec in ("NETWORK", "POSE_RESNET", "LOSS", "LOCAL_DISCRIMINATOR", "VIEW_DISCRIMINATOR",
                "JOINTS_DISCRIMINATOR", "HEATMAP_DISCRIMINATOR"):
        for k, v in jcfg[sec].items():
            c[sec][k] = v
    return c


def port_critics(cfg, variables, dtype=torch.float32) -> dict:
    """The port's critics with the carried variables."""
    mods = build_discriminators(cfg)
    for name, m in mods.items():
        m.load_state_dict(from_jax_critic_variables(variables[name], m))
        m.to(dtype)
    return mods


def jax_apply(dm, variables, train=True):
    """A Flax critic bound to its variables, as the JAX step applies it:
    batch statistics in training mode, the mutated ones thrown away."""

    def apply(*xs):
        if not train:
            return dm.apply(variables, *xs, train=False)
        return dm.apply(variables, *xs, train=True, mutable=["batch_stats"])[0]

    return apply


@contextmanager
def recording(module, name):
    """Record each call's (args, result) of ``module.name`` meanwhile."""
    calls, orig = [], getattr(module, name)

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@partial(jax.jit, static_argnums=(3, 5, 6, 7))
def _joint_variant_draws(key, jc, jv, h, stride, pos, q, sigma):
    """JAX's joint-variant pair extraction, its two categorical_rows calls'
    log-weights and draws recorded (the features do not enter them)."""
    with recording(jmi, "categorical_rows") as calls:
        jmi.extract_local_pairs_joint(key, jnp.zeros((jc.shape[0], h, h, 1)), jc, jv, stride,
                                      pos, q, sigma)
    (bg_args, bg), (neg_args, neg) = calls
    return bg[0], neg, bg_args[1], neg_args[1]


def jax_local_draws(key, joints_crop, joints_vis, jcfg):
    """The draws JAX's local_mi_loss makes from ``key``, as
    core/mi.sample_local_pairs returns them, and (joint variant) the
    log-weights it samples them from: the joint variant's through
    posetpu.core.mi.categorical_rows, recorded; the org / one_image
    variants' randints replayed."""
    n, j = joints_crop.shape[:2]
    pos, q = int(jcfg.LOSS.MI_POSITIVE_NUM), int(jcfg.LOSS.MI_NEG_POS_RATIO)
    stride = jnp.asarray(jcfg.NETWORK.IMAGE_SIZE / jcfg.NETWORK.HEATMAP_SIZE, jnp.float32)
    if jcfg.LOSS.SPECIFIC == "joint":
        bg, neg, bg_logw, neg_logw = _joint_variant_draws(
            key, jnp.asarray(joints_crop), jnp.asarray(joints_vis),
            int(jcfg.NETWORK.HEATMAP_SIZE[1]), stride, pos, q, int(jcfg.NETWORK.SIGMA))
        return ({"bg": np.asarray(bg), "neg": np.asarray(neg)},
                (np.asarray(bg_logw), np.asarray(neg_logw)))
    k1, k2, k3 = jax.random.split(key, 3)
    nneg = q * (pos + j)
    cells = jax.random.randint(k1, (n, pos, 2), 0, 64)
    if jcfg.LOSS.SPECIFIC == "org":
        neg = jax.random.randint(k2, (n, nneg), 0, (n - 1) * 36)
    else:
        neg = jax.random.randint(k3, (n, nneg), 0, 35)
    return {"cells": np.asarray(cells), "neg": np.asarray(neg)}, None


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _heatmap_cells(key, jc, jv, image, heatmap, sigma, joint_idx):
    """JAX's heatmap MI on zeros, its _sample_heatmap_indices' result
    recorded."""
    c = jax_config()
    c.NETWORK.IMAGE_SIZE, c.NETWORK.HEATMAP_SIZE = np.array(image), np.array(heatmap)
    c.NETWORK.SIGMA = sigma
    n, h = jc.shape[0], heatmap[1]
    with recording(jmi, "_sample_heatmap_indices") as calls:
        jmi.heatmap_mi_loss(key, lambda pairs: jnp.zeros(pairs.shape[:1] + (1,)),
                            jnp.zeros((n, h, h, 1)), jnp.zeros((n, h, h, 16)), jc, jv, c,
                            joint_idx)
    return calls[0][1]


def jax_heatmap_draws(key, joints_crop, joints_vis, jcfg, joint_idx):
    """The cells JAX's heatmap_mi_loss draws from ``key`` [N, Q], recorded
    from its own _sample_heatmap_indices."""
    return np.asarray(_heatmap_cells(
        key, jnp.asarray(joints_crop), jnp.asarray(joints_vis),
        tuple(int(v) for v in jcfg.NETWORK.IMAGE_SIZE),
        tuple(int(v) for v in jcfg.NETWORK.HEATMAP_SIZE), int(jcfg.NETWORK.SIGMA), joint_idx))


def _t(*arrays, grad=False):
    out = [torch.tensor(np.asarray(a), requires_grad=grad) for a in arrays]
    return out[0] if len(out) == 1 else out


def _close_grad(got, ref, rel=1e-5, allow_zero=False):
    """Within ``rel`` of the reference's largest element; a zero reference
    (``allow_zero``) matches an absent or zero gradient."""
    ref = np.asarray(ref)
    if allow_zero and not np.abs(ref).max():
        assert got is None or not got.abs().max()
        return
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * np.abs(ref).max())


# ------------------------------------------------------------------ measures


@pytest.mark.parametrize("measure", tl.MEASURES)
def test_measure_matches_jax(rng, measure):
    pos = rng.randn(6, 32).astype(np.float32)
    neg = rng.randn(6, 32).astype(np.float32)
    for average in (True, False):
        np.testing.assert_allclose(
            tl.positive_expectation(_t(pos), measure, average).numpy(),
            np.asarray(jl.positive_expectation(pos, measure, average)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tl.negative_expectation(_t(neg), measure, average).numpy(),
            np.asarray(jl.negative_expectation(neg, measure, average)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl.fenchel_dual_loss(*_t(pos, neg), measure)),
                               float(jl.fenchel_dual_loss(pos, neg, measure)), rtol=1e-5)


def test_unknown_measure_is_refused():
    with pytest.raises(ValueError, match="measure"):
        tl.positive_expectation(torch.zeros(3), "nce")
    with pytest.raises(ValueError, match="measure"):
        tl.negative_expectation(torch.zeros(3), "nce")


def test_paired_losses_and_bce_match_jax(rng):
    e1, e2 = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    np.testing.assert_allclose(float(tl.infonce_paired(*_t(e1, e2))),
                               float(jl.infonce_paired(e1, e2)), rtol=1e-5)
    np.testing.assert_allclose(float(tl.jsd_paired(*_t(e1, e2))),
                               float(jl.jsd_paired(e1, e2)), rtol=1e-5)
    s = np.concatenate([rng.uniform(0.01, 0.99, 20), [0.0, 1.0, 1e-9]]).astype(np.float32)
    y = (rng.uniform(size=23) > 0.5).astype(np.float32)  # the clip at 1e-7 reached
    np.testing.assert_allclose(float(tl.bce_loss(*_t(s, y))), float(jl.bce_loss(s, y)),
                               rtol=1e-5)


# ------------------------------------------------------------------ geometry


def test_camera_projections_match_jax():
    jc, tc = jax_camera_ring(), make_camera_ring()
    pts = make_poses3d(3).reshape(-1, 3).astype(np.float32)
    x = np.broadcast_to(pts, (4,) + pts.shape).copy()
    xt = torch.from_numpy(x)
    cam_frame = tcam.world_to_camera_frame(xt, tc.R, tc.T)
    np.testing.assert_allclose(cam_frame.numpy(),
                               np.asarray(jcam.world_to_camera_frame(x, jc.R, jc.T)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tcam.camera_to_world_frame(cam_frame, tc.R, tc.T).numpy(), x,
                               rtol=1e-5, atol=1e-2)  # mm at 5 m: f32's rounding
    np.testing.assert_allclose(tcam.project_pose(xt, tc).numpy(),
                               np.asarray(jcam.project_pose(x, jc)), rtol=1e-5, atol=1e-3)
    for nd in (False, True):
        np.testing.assert_allclose(tcam.project_points(xt, tc, no_distortion=nd).numpy(),
                                   np.asarray(jcam.project_points(x, jc, no_distortion=nd)),
                                   rtol=1e-5, atol=1e-3)
    y = np.random.RandomState(1).uniform(-0.4, 0.4, (4, 10, 2)).astype(np.float32)
    np.testing.assert_allclose(tcam.distort_opencv(torch.from_numpy(y), tc.k, tc.p).numpy(),
                               np.asarray(jcam.distort_opencv(y, jc.k, jc.p)),
                               rtol=1e-6, atol=1e-7)


def test_eight_point_matches_jax():
    """The camera ring's views 0 and 1 (tests/test_losses.py's case): the
    port's F within 1e-4 of JAX's (both scaled to max |entry| 1; the sign
    of an eigenvector is free) and annihilating the projections."""
    jc, tc = jax_camera_ring(distortion=False), make_camera_ring(distortion=False)
    pts = make_poses3d(8).reshape(-1, 3).astype(np.float32)
    p0 = tcam.project_pose(torch.from_numpy(pts), tc.map(lambda a: a[0]))
    p1 = tcam.project_pose(torch.from_numpy(pts), tc.map(lambda a: a[1]))
    got = tfund.eight_point(p0, p1).numpy()
    ref = np.asarray(jfund.eight_point(
        jcam.project_pose(pts, jax.tree.map(lambda a: a[0], jc)),
        jcam.project_pose(pts, jax.tree.map(lambda a: a[1], jc))))
    sign = np.sign((got * ref).sum())
    np.testing.assert_allclose(sign * got, ref, atol=1e-4)
    h0 = np.concatenate([p0.numpy(), np.ones((len(pts), 1))], 1)
    h1 = np.concatenate([p1.numpy(), np.ones((len(pts), 1))], 1)
    assert np.abs(np.einsum("nj,jk,nk->n", h1, got, h0)).max() < 0.05


def test_load_reference_bank_matches_jax(tmp_path):
    """A pickle in the reference's format ({(subject, a, b): 3x3 float64
    list}) reads alike in both packages."""
    rs = np.random.RandomState(3)
    raw = {(s, a, b): rs.randn(3, 3).tolist() for s in (1, 5) for a in range(4)
           for b in range(4) if a != b}
    path = tmp_path / "fundamental_matrix.pkl"
    path.write_bytes(pickle.dumps(raw))
    got, ref = tfund.load_reference_bank(str(path)), jfund.load_reference_bank(str(path))
    assert set(got) == set(ref) == set(raw)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


# ------------------------------------------------------------------ samplers


def test_categorical_rows_respects_mask():
    logw = torch.zeros(3, 10)
    logw[:, :5] = -torch.inf
    idx = tmi.categorical_rows(logw, 64, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 64) and int(idx.min()) >= 5


def test_gumbel_topk_without_replacement():
    idx = tmi.gumbel_topk_rows(torch.zeros(2, 20), 10, torch.Generator().manual_seed(1))
    for row in idx.tolist():
        assert len(set(row)) == 10


@pytest.mark.parametrize("sampler", ["categorical", "gumbel"])
def test_sampler_frequencies_are_uniform_over_unmasked_cells(sampler):
    """20,000 draws over 12 unmasked cells of 16 (8 masked cells never
    drawn): each count within 5 standard deviations of 20000 / 12; the
    Gumbel top-k (3 of each row) drawn per row without repeats."""
    gen = torch.Generator().manual_seed(4)
    logw = torch.zeros(16)
    logw[torch.tensor([0, 3, 7, 12])] = -torch.inf
    if sampler == "categorical":
        idx = tmi.categorical_rows(logw[None], 20000, gen).reshape(-1)
    else:
        idx = tmi.gumbel_topk_rows(logw.expand(20000 // 3 + 1, 16).contiguous(), 3, gen)
        assert all(len(set(r)) == 3 for r in idx.tolist())
        idx = idx.reshape(-1)
    counts = torch.bincount(idx, minlength=16).double()
    assert counts[logw == -torch.inf].sum() == 0
    free = counts[logw == 0]
    expect = idx.numel() / 12
    # without replacement, the per-row draws are dependent: 5 sigma of the
    # binomial still holds them (a row's 3 cells differ)
    assert float((free - expect).abs().max()) < 5 * (expect * (1 - 1 / 12)) ** 0.5, free


def test_local_joint_masks_match_jax_and_are_respected(rng):
    """The port's background and negative masks are the log-weights the JAX
    package samples from, and its draws keep out of them."""
    jcfg, cfg = cfgs()
    jc = rng.uniform(-5, 70, (3, 16, 2)).astype(np.float32)  # some off the crop
    jv = (rng.rand(3, 16) > 0.2).astype(np.float32)
    _, (bg_ref, neg_ref) = jax_local_draws(jax.random.PRNGKey(0), jc, jv, jcfg)
    bg, neg = tmi.local_joint_log_weights(torch.from_numpy(jc), tmi._feat_stride(cfg),
                                          (16, 16), int(cfg.NETWORK.SIGMA))
    np.testing.assert_array_equal(bg.numpy(), bg_ref)
    np.testing.assert_array_equal(neg.numpy(), neg_ref)
    d = tmi.sample_local_pairs(torch.from_numpy(jc), cfg, torch.Generator().manual_seed(0))
    t, q = int(cfg.LOSS.MI_POSITIVE_NUM), int(cfg.LOSS.MI_NEG_POS_RATIO)
    assert d["bg"].shape == (2 * t,) and d["neg"].shape == (3 * 16, q)
    assert torch.isfinite(bg[0, d["bg"]]).all()
    assert torch.isfinite(torch.gather(neg, 1, d["neg"])).all()


def test_heatmap_cells_sampler():
    """At 64x64 maps (radius 3 sigma + 2 = 8, 289-cell window, Q = 216),
    joints 10 cells or more from the map's edges: the first 144 cells lie
    in the window around the joint without repeats, the other 72 outside
    it, without repeats. An invisible joint's window is around a random
    cell, which may lie at an edge, where the clipped window repeats
    cells (as in JAX): there the 72 are still distinct and outside the
    144."""
    _, cfg = cfgs()
    cfg.NETWORK.IMAGE_SIZE = np.array([256, 256])
    cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64])
    gen = torch.Generator().manual_seed(2)
    jc = 40 + torch.rand(6, 16, 2, generator=gen) * 176
    jv = torch.ones(6, 16)
    jv[0, 3] = 0.0
    idx = tmi.sample_heatmap_cells(jc, jv, cfg, 3, gen)
    assert idx.shape == (6, 216)
    cells = tmi._gt_heatmap_cells(jc, tmi._feat_stride(cfg), 64)
    for row in range(6):
        hi, lo = set(idx[row, :144].tolist()), set(idx[row, 144:].tolist())
        assert len(lo) == 72 and not hi & lo
        if row == 0:
            continue
        assert len(hi) == 144
        loc = int(cells[row, 3, 1] * 64 + cells[row, 3, 0])
        window = set(torch.clamp(loc + tmi._window(8, 64, "cpu"), 0, 4095).tolist())
        assert hi <= window and not lo & window


def test_sample_draws_follow_the_parity():
    """The D side draws the heatmap cells at parity 0, the G side at 1;
    both sides draw the local pairs, one set a view."""
    _, cfg = cfgs()
    gen = torch.Generator().manual_seed(0)
    batch = {"joints_crop": torch.rand(2, 4, 16, 2, generator=gen) * 64,
             "joints_vis": torch.ones(2, 4, 16)}
    d0, d1 = (tmi.sample_draws(batch, cfg, p, gen) for p in (0, 1))
    assert set(d0["d"]) == {"local", "heatmap"} and set(d0["g"]) == {"local"}
    assert set(d1["d"]) == {"local"} and set(d1["g"]) == {"local", "heatmap"}
    assert len(d0["d"]["local"]) == len(d1["g"]["heatmap"]) == 4
    assert not torch.equal(d0["d"]["local"][0]["bg"], d0["g"]["local"][0]["bg"])


# ------------------------------------------------------------------ critics


def _critic_inputs(name, rng):
    n = 4
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"local_discriminator": (r(1, 40, HIGH_C), r(1, 40, HIGH_C)),
            "domain_discriminator": (r(n, 16, 16, LOW_C),),
            "view_discriminator": (r(n, 32), r(n, 96)),
            "joints_discriminator": (r(n, 8), r(n, 24)),
            "heatmap_discriminator": (r(300, 1 + LOW_C),)}[name]


@pytest.mark.parametrize("name", CRITICS)
def test_critic_forward_matches_jax(rng, name):
    """Training mode (batch statistics) and eval mode (the carried running
    ones) on carried weights; the running statistics are untouched by the
    training-mode forward. The domain critic's patch map is 5x5 on 16x16
    features (29x29 on 64x64)."""
    jcfg, cfg = cfgs()
    defs, variables = jax_critic_variables(jcfg, rng)
    m = port_critics(cfg, variables)[name]
    xs = _critic_inputs(name, rng)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    for train in (True, False):
        m.train(train)
        with torch.no_grad():
            got = m(*_t(*xs) if len(xs) > 1 else [_t(*xs)])
        ref = jax_apply(defs[name], variables[name], train)(*map(jnp.asarray, xs))
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert g.shape == r.shape
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                       atol=1e-5 * max(1.0, np.abs(r).max()), err_msg=str(train))
    if name == "domain_discriminator":
        assert got[0].shape == (4, 5, 5, 1)
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_critic_batchnorm_never_updates_running_statistics():
    bn = BatchNorm(3)
    bn.train()
    y = bn(torch.randn(8, 3) * 5 + 2)
    assert torch.equal(bn.running_mean, torch.zeros(3)) and torch.equal(bn.running_var,
                                                                        torch.ones(3))
    torch.testing.assert_close(y.mean(0), torch.zeros(3), atol=1e-5, rtol=0)


def test_build_discriminators_shapes_and_init():
    """Keyed like JAX's dict; the input widths read off the configuration
    (ResNet-18: 64 low, 256 high channels; ResNet-50: 256 low); the
    shortcuts' noisy identity."""
    _, cfg = cfgs()
    mods = build_discriminators(cfg, torch.Generator().manual_seed(0))
    assert tuple(mods) == CRITICS
    assert mods["heatmap_discriminator"].fc1.in_features == 1 + LOW_C
    assert mods["domain_discriminator"].conv1.in_channels == LOW_C
    assert mods["local_discriminator"].low_net.conv1.in_features == HIGH_C
    sc = mods["view_discriminator"].view1_net.shortcut.weight
    assert torch.equal(sc.diagonal(), torch.ones(32))
    assert float(sc.detach().triu(1).abs().max()) <= 0.01
    cfg.POSE_RESNET.NUM_LAYERS = 50
    assert build_discriminators(cfg)["heatmap_discriminator"].fc1.in_features == 257


# ------------------------------------------------------------------ MI losses


def _local_case(rng, specific, measure):
    """Configs, the critic (64 channels; for 'org' / 'one_image' on 8x8 low
    features of 28 channels, so 252-channel patches) as a Flax apply and
    the port's module, features, joints."""
    jcfg, cfg = cfgs(SPECIFIC=specific, MI_MEASURE=measure, MI_POSITIVE_NUM=16,
                     MI_NEG_POS_RATIO=2)
    n, low_c = 3, HIGH_C if specific == "joint" else 9 * 28
    m = LocalDiscriminator(low_c, HIGH_C, 64).reset_parameters(torch.Generator().manual_seed(7))
    variables = np_flax_variables(m, rng)
    m.load_state_dict(from_jax_critic_variables(variables, m))
    dm = jax_discriminators(jcfg)["local_discriminator"].clone(out_channels=64)
    if specific == "joint":
        low = high = rng.randn(n, 16, 16, HIGH_C).astype(np.float32)
        jc = rng.uniform(0, 64, (n, 16, 2)).astype(np.float32)
    else:
        low = rng.randn(n, 8, 8, 28).astype(np.float32)
        high = rng.randn(n, 64, 64, HIGH_C).astype(np.float32)
        jc = rng.uniform(0, 256, (n, 16, 2)).astype(np.float32)
    jv = (rng.rand(n, 16) > 0.2).astype(np.float32)
    return jcfg, cfg, jax_apply(dm, variables), m, low, high, jc, jv


@pytest.mark.parametrize("specific,measure", [("joint", "JSD"), ("org", "JSD"),
                                              ("org", "NCE"), ("one_image", "GAN")])
def test_local_mi_loss_matches_jax(rng, specific, measure):
    """The local MI loss (pairs, critic, measure, gradient penalty) with
    JAX's draws: value, and the gradients with respect to the feature maps
    (the joint variant reads one map as both)."""
    jcfg, cfg, d_apply, m, low, high, jc, jv = _local_case(rng, specific, measure)
    key = jax.random.PRNGKey(5)
    draws, _ = jax_local_draws(key, jc, jv, jcfg)
    draws = {k: torch.tensor(v).long() for k, v in draws.items()}
    if specific == "joint":
        fn = lambda h: jmi.local_mi_loss(key, d_apply, h, h, jc, jv, jcfg)  # noqa: E731
        ref, ref_g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(high))
        ref_g = (ref_g,)
        inputs = (_t(high, grad=True),) * 2
    else:
        fn = lambda lo, h: jmi.local_mi_loss(key, d_apply, lo, h, jc, jv, jcfg)  # noqa: E731
        ref, ref_g = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(jnp.asarray(low),
                                                                      jnp.asarray(high))
        inputs = tuple(_t(low, high, grad=True))
    got = tmi.local_mi_loss(m.train(), *inputs, *_t(jc, jv), cfg, draws)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for t, r in zip(inputs, ref_g):
        _close_grad(t.grad, r)


def test_local_pairs_org_match_jax(rng):
    """Both org layouts' pair tensors equal JAX's under its draws; the
    one_image negatives never take the positive's own patch."""
    n = 3
    low = rng.randn(n, 8, 8, 5).astype(np.float32)
    high = rng.randn(n, 64, 64, 7).astype(np.float32)
    jc = rng.uniform(0, 256, (n, 16, 2)).astype(np.float32)
    stride = np.array([4.0, 4.0], np.float32)
    jcfg, _ = cfgs(MI_POSITIVE_NUM=16, MI_NEG_POS_RATIO=2)
    for cross, specific in ((True, "org"), (False, "one_image")):
        jcfg.LOSS.SPECIFIC = specific
        key = jax.random.PRNGKey(1)
        draws, _ = jax_local_draws(key, jc, None, jcfg)
        ref = jmi.extract_local_pairs_org(key, low, high, jc, stride, 16, 2, cross_image=cross)
        got = tmi.extract_local_pairs_org(*_t(low, high, jc), stride, 16, 2,
                                          {k: torch.from_numpy(v).long() for k, v in
                                           draws.items()}, cross_image=cross)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tmi._unfold_3x3(_t(low)).numpy(),
                                  np.asarray(jmi._unfold_3x3(low)))
    with pytest.raises(ValueError, match="8x8"):
        tmi.extract_local_pairs_org(_t(high[:, :16, :16]), _t(high), _t(jc), stride, 16, 2,
                                    {k: torch.from_numpy(v).long() for k, v in draws.items()})


@pytest.mark.parametrize("measure", ["NCE", "JSD"])
def test_heatmap_mi_loss_matches_jax(rng, measure):
    """The heatmap MI with JAX's cells: value and the gradients with respect
    to the features and the heatmaps (one joint's map only)."""
    jcfg, cfg = cfgs(HEATMAP_MI_MEASURE=measure)
    defs, variables = jax_critic_variables(jcfg, rng)
    n, joint_idx = 2, 3
    feats = rng.randn(n, 16, 16, LOW_C).astype(np.float32)
    hm = rng.rand(n, 16, 16, 16).astype(np.float32)
    jc = rng.uniform(0, 64, (n, 16, 2)).astype(np.float32)
    jv = np.ones((n, 16), np.float32)
    jv[1, joint_idx] = 0.0
    key = jax.random.PRNGKey(9)
    idx = jax_heatmap_draws(key, jc, jv, jcfg, joint_idx)
    assert idx.shape == (n, 216)
    d_apply = jax_apply(defs["heatmap_discriminator"], variables["heatmap_discriminator"])
    fn = lambda f, h: jmi.heatmap_mi_loss(key, d_apply, f, h, jc, jv, jcfg, joint_idx)  # noqa
    ref, (gf_ref, gh_ref) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(feats, hm)
    m = port_critics(cfg, variables)["heatmap_discriminator"]
    f_t, h_t = _t(feats, hm, grad=True)
    got = tmi.heatmap_mi_loss(m, f_t, h_t, torch.from_numpy(idx).long(), cfg, joint_idx)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    _close_grad(f_t.grad, gf_ref)
    _close_grad(h_t.grad, gh_ref)
    assert float(h_t.grad[..., :joint_idx].abs().max()) == 0


@pytest.mark.parametrize("measure", ["NCE", "JSD"])
def test_view_and_joints_mi_match_jax(rng, measure):
    """View MI on [N, 4, J, 2] pixels and joints MI on one view's [N, J, 2]
    (also with the second subset's gradient stopped): value and gradient
    with respect to the joints."""
    jcfg, cfg = cfgs()
    defs, variables = jax_critic_variables(jcfg, rng)
    mods = port_critics(cfg, variables)
    j2d = rng.uniform(0, 500, (4, 4, 16, 2)).astype(np.float32)
    idx = (0, 5, 10, 15)
    cases = [("view_discriminator", lambda d, x: jmi.view_mi_loss(d, x, 1, measure),
              lambda d, x: tmi.view_mi_loss(d, x, 1, measure), j2d)]
    for stop in (False, True):
        cases.append(("joints_discriminator",
                      lambda d, x, s=stop: jmi.joints_mi_loss(d, x, idx, measure, s),
                      lambda d, x, s=stop: tmi.joints_mi_loss(d, x, idx, measure, s), j2d[:, 1]))
    for name, jfn, tfn, x in cases:
        d_apply = jax_apply(defs[name], variables[name])
        ref, ref_g = jax.jit(jax.value_and_grad(lambda a: jfn(d_apply, a)))(x)
        x_t = _t(x, grad=True)
        got = tfn(mods[name], x_t)
        got.backward()
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=name)
        _close_grad(x_t.grad, ref_g)


def test_domain_losses_match_jax(rng):
    """The discriminator side (BCE against mpii 1.0 / h36m 0.1, accuracy,
    the critic's weight gradients) and the generator side (value and the
    features' gradient) on [N, V, 16, 16, 64] features."""
    jcfg, cfg = cfgs()
    defs, variables = jax_critic_variables(jcfg, rng)
    m = port_critics(cfg, variables)["domain_discriminator"]
    feats = rng.randn(3, 4, 16, 16, LOW_C).astype(np.float32)
    is_mpii = np.array([1.0, 0.0, 1.0], np.float32)
    dm, var = defs["domain_discriminator"], variables["domain_discriminator"]

    def jd(params):
        return jmi.domain_d_loss(jax_apply(dm, {**var, "params": params}), feats, is_mpii)

    (ref, ref_acc), ref_g = jax.jit(jax.value_and_grad(jd, has_aux=True))(var["params"])
    got, acc = tmi.domain_d_loss(m, *_t(feats, is_mpii))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert round(float(acc) * 12) == round(float(ref_acc) * 12)  # the same hits of 12
    g_ref = from_jax_critic_variables({"params": jax.tree.map(np.asarray, ref_g)}, m)
    for k, p in m.named_parameters():
        _close_grad(p.grad, g_ref[k])

    jg = lambda f: jmi.domain_g_loss(jax_apply(dm, var), f, is_mpii)  # noqa: E731
    ref, ref_g = jax.jit(jax.value_and_grad(jg))(feats)
    f_t = _t(feats, grad=True)
    got = tmi.domain_g_loss(m, f_t, _t(is_mpii))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    _close_grad(f_t.grad, ref_g)


def test_gradient_penalty_gradient_matches_jax(rng):
    """The penalty is a gradient inside the loss: on the critic's side its
    own gradient with respect to the critic's weights (a second-order
    gradient through BN and LayerNorm) equals JAX's; with create_graph off
    it is the same value and carries no gradient."""
    jcfg, cfg = cfgs()
    jcfg.LOCAL_DISCRIMINATOR.OUTPUT_CHANNELS = cfg.LOCAL_DISCRIMINATOR.OUTPUT_CHANNELS = 64
    defs, variables = jax_critic_variables(jcfg, rng)
    dm, var = defs["local_discriminator"], variables["local_discriminator"]
    a = rng.randn(1, 30, HIGH_C).astype(np.float32)
    b = rng.randn(1, 30, HIGH_C).astype(np.float32)

    def jgp(params):
        return jmi.contrastive_gradient_penalty(jax_apply(dm, {**var, "params": params}), [a, b])

    ref, ref_g = jax.jit(jax.value_and_grad(jgp))(var["params"])
    m = port_critics(cfg, variables)["local_discriminator"]
    got = tmi.contrastive_gradient_penalty(m, _t(a, b))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    g_ref = from_jax_critic_variables({"params": jax.tree.map(np.asarray, ref_g)}, m)
    for k, p in m.named_parameters():  # the last LayerNorm's shift: no gradient
        _close_grad(p.grad, g_ref[k], rel=1e-4, allow_zero=k.endswith("ln.bias"))
    value = tmi.contrastive_gradient_penalty(m, _t(a, b), create_graph=False)
    assert not value.requires_grad and float(value) == pytest.approx(float(got), rel=1e-6)
