"""The adversarial train step: the critics' updates, then the base model's.

The reference's inner loop (lib/core/function.py:191-367), step for step as
the JAX package's ``make_adversarial_train_step``:

1. one base forward in training mode, its graph kept; the new BN running
   statistics are this forward's;
2. the discriminator side: one loss over the detached (raw, fused, low,
   high) features, backward into the critics, and each critic steps with its
   own optimizer, at both parities, also a critic whose loss is absent at
   this parity (its gradient is zero: train/optim.py steps it as optax
   does);
3. the generator side: the supervised losses plus the adversarial terms,
   scored by the just-updated critics with their parameters held constant
   (``requires_grad`` off, so no ``.grad`` collects on them), backward
   through the kept graph, and the base optimizer steps.

The heatmap, view and joints MI terms switch sides by ``epoch_parity``: the
critics' on even epochs, the generator's on odd ones (function.py:263, 317,
336). The critics run in training mode on batch statistics and their
running statistics never change, as the JAX step discards them.

The JAX package's divergences from the reference are kept (its
train/gan.py docstring): the view, joints and fundamental terms run over
the whole batch scaled by the h36m fraction, and the local MI reads the
deconv features as both its low and its high input, so SPECIFIC='joint' is
the variant the step runs.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable

import torch

from posetpu_torch import resolve_device
from posetpu_torch.core.inference import fuse_routing
from posetpu_torch.core.losses import consistency_loss, fundamental_loss, joints_mse_loss
from posetpu_torch.core.mi import (
    domain_d_loss,
    domain_g_loss,
    heatmap_mi_loss,
    joints_mi_loss,
    local_mi_loss,
    sample_draws,
    view_mi_loss,
)
from posetpu_torch.models.multiview import require_pose_resnet
from posetpu_torch.parallel.batchnorm import sync_batch_stats
from posetpu_torch.parallel.mesh import all_reduce_grads, check_mesh, gather_rows
from posetpu_torch.train.state import TrainState
from posetpu_torch.train.step import _acc, _integral_joints_image_coords, _on
from posetpu_torch.utils.gradients import grad_norms_wrt_heatmaps


@contextmanager
def _frozen(modules):
    """Every parameter of ``modules`` with ``requires_grad`` off meanwhile."""
    params = [p for m in modules for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return torch.as_tensor(tree, device=dev)


def make_adversarial_train_step(model, disc_models: dict, cfg, tx_base, tx_disc: dict,
                                mesh=None, device=None, seed: int = 0) -> Callable:
    """``step(states, batch, epoch_parity=0, draws=None) -> (states,
    metrics)``.

    ``states``: {"base_model": TrainState of ``model`` (a MultiViewPose),
    name: TrainState of ``disc_models[name]`` for each critic} (train/
    state.py; init_train_state and :func:`init_discriminator_states`); the
    modules and optimizer states advance in place and the states come back
    with ``step`` one higher. ``tx_base`` and ``tx_disc[name]`` are
    train/optim.py optimizers (``make_optimizer(cfg, n,
    discriminator=True)`` for the critics). ``batch``: the supervised
    step's (train/step.py) plus joints_crop [N, V, J, 2] and joints_vis
    [N, V, J] for the MI samplers. ``draws``: core/mi.sample_draws's
    indices; by default drawn from a generator on the device seeded with
    ``seed``.

    Metrics, as the JAX step emits them: local_mi_d / _g, domain_d,
    domain_acc_d, domain_g, hmi_d / vmi_d / jmi_d (parity 0), hmi_g / vmi_g
    / jmi_g (parity 1), mse_loss, consistent_loss, fund_loss, loss, acc and,
    with ``LOSS.WATCH_GRAD_NORM``, grad_norm_*; each where its loss runs.

    With ``mesh`` (parallel/mesh.data_mesh) each rank takes its own rows
    of the global batch. BatchNorm's moments are the global batch's; the
    four feature maps are gathered (this rank's rows live, the others'
    detached), and every rank draws the global batch's MI indices from the
    same seed (``draws``, where given, are the global batch's). The critics
    then run on the same global features on every rank, so their updates
    are equal with no reduction; the base model's gradient is this rank's
    share through the gather, summed over the ranks by one all-reduce a
    dtype before its optimizer steps.

    CUDA unless ``device`` is given (under a mesh, the mesh's device). The
    critics read PoseResNet's layer1 and deconv features: another backbone
    is refused (ValueError)."""
    require_pose_resnet(model, "the adversarial step (its critics are sized for ResNet's layer1)")
    check_mesh(mesh, "make_adversarial_train_step")
    dev = resolve_device(device if mesh is None else mesh.device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    loss_cfg = cfg.LOSS
    is_aggre = bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None
    fuse_output = bool(cfg.TEST.FUSE_OUTPUT)
    use_tw = bool(loss_cfg.USE_TARGET_WEIGHT)
    hm_size = (int(cfg.NETWORK.HEATMAP_SIZE[0]), int(cfg.NETWORK.HEATMAP_SIZE[1]))
    use = {"local": bool(loss_cfg.USE_LOCAL_MI_LOSS),
           "domain": bool(loss_cfg.USE_DOMAIN_TRANSFER_LOSS),
           "heatmap": bool(loss_cfg.USE_HEATMAP_MI_LOSS),
           "view": bool(loss_cfg.USE_VIEW_MI_LOSS),
           "joints": bool(loss_cfg.USE_JOINTS_MI_LOSS),
           "fund": bool(loss_cfg.USE_FUNDAMENTAL_LOSS),
           "consistent": bool(loss_cfg.USE_CONSISTENT_LOSS)}
    w = {"mse": float(loss_cfg.MSE_LOSS_WEIGHT),
         "local": float(loss_cfg.LOCAL_MI_LOSS_WEIGHT),
         "domain": float(loss_cfg.DOMAIN_LOSS_WEIGHT),
         "heatmap": float(loss_cfg.HEATMAP_MI_LOSS_WEIGHT),
         "view": float(loss_cfg.VIEW_MI_LOSS_WEIGHT),
         "joints": float(loss_cfg.JOINTS_MI_LOSS_WEIGHT),
         "fund": float(loss_cfg.FUNDAMENTAL_LOSS_WEIGHT),
         "consistent": float(loss_cfg.CONSISTENT_LOSS_WEIGHT)}
    joint_idx = int(cfg.HEATMAP_DISCRIMINATOR.JOINT_IDX)
    view1_num = int(cfg.VIEW_DISCRIMINATOR.VIEW_ONE_NUM)
    var1_idx = tuple(int(i) for i in cfg.JOINTS_DISCRIMINATOR.VAR_ONE_IDX)
    view_measure, joints_measure = loss_cfg.VIEW_MI_MEASURE, loss_cfg.JOINTS_MI_MEASURE
    watch_grad = bool(loss_cfg.WATCH_GRAD_NORM)

    def routed(raw, fused, b):
        return fuse_routing(raw, fused, b["is_h36m"]) if (is_aggre and fuse_output) else raw

    def joints2d_of(output, b):
        return _integral_joints_image_coords(output, b["center"], b["scale"], hm_size)

    def per_view(loss_of, views):
        total = 0.0
        for v in range(views):
            total = total + loss_of(v)
        return total

    def local_term(d, high, b, draws):
        jc, jv = b["joints_crop"], b["joints_vis"]
        return per_view(lambda v: local_mi_loss(d, high[:, v], high[:, v], jc[:, v], jv[:, v],
                                                cfg, draws[v]), high.shape[1])

    def heatmap_term(d, low, output, draws, weight=1.0):
        return per_view(lambda v: heatmap_mi_loss(d, low[:, v], output[:, v], draws[v], cfg,
                                                  joint_idx) * weight, low.shape[1])

    def joints_term(d, j2d):
        return per_view(lambda v: joints_mi_loss(d, j2d[:, v], var1_idx, joints_measure),
                        j2d.shape[1])

    def fund_term(j2d, b):
        # the JAX step weights by the targets whatever USE_TARGET_WEIGHT_FUND
        # says, and normalises by the h36m subset's size (loss.py:132)
        fl = fundamental_loss(j2d, b["weight"], b["fmats"], sample_mask=b["is_h36m"])
        return fl * (j2d.shape[0] / torch.clamp(b["is_h36m"].sum(), min=1.0)) * w["fund"]

    def mse_term(raw, output, b):
        tw = b["weight"] if use_tw else None
        m = joints_mse_loss(raw, b["target"], tw) * raw.shape[1] * w["mse"]
        if is_aggre:
            m = m + joints_mse_loss(output, b["target"], tw) * raw.shape[1] * w["mse"]
        return m

    # ------------------------------------------------------------- D side

    def d_losses(ds, feats, b, draws, parity):
        """The critics' total loss over the detached features, and its
        metrics (the D-side terms carry no loss weight but the local MI's,
        as in the JAX step)."""
        raw, fused, low, high = (t.detach() for t in feats)
        output = routed(raw, fused, b)
        total, metrics = 0.0, {}
        if use["local"]:
            metrics["local_mi_d"] = local_term(ds["local_discriminator"], high, b,
                                               draws["local"]) * w["local"]
            total = total + metrics["local_mi_d"]
        if use["domain"]:
            metrics["domain_d"], metrics["domain_acc_d"] = domain_d_loss(
                ds["domain_discriminator"], low, 1.0 - b["is_h36m"])
            total = total + metrics["domain_d"]
        if use["heatmap"] and parity == 0:
            metrics["hmi_d"] = heatmap_term(ds["heatmap_discriminator"], low, output,
                                            draws["heatmap"])
            total = total + metrics["hmi_d"]
        if (use["view"] or use["joints"]) and parity == 0:
            j2d = joints2d_of(output, b)
            frac = b["is_h36m"].mean()
            if use["view"]:
                metrics["vmi_d"] = view_mi_loss(ds["view_discriminator"], j2d, view1_num,
                                                view_measure) * frac
                total = total + metrics["vmi_d"]
            if use["joints"]:
                metrics["jmi_d"] = joints_term(ds["joints_discriminator"], j2d) * frac
                total = total + metrics["jmi_d"]
        return total, metrics

    # ------------------------------------------------------------- G side

    def g_loss(ds, feats, b, draws, parity):
        raw, fused, low, high = feats
        output = routed(raw, fused, b)
        loss = mse_term(raw, output, b)
        metrics = {"mse_loss": loss}
        if use["consistent"] and is_aggre:
            metrics["consistent_loss"] = (consistency_loss(raw, fused, b["is_h36m"])
                                          * w["consistent"])
            loss = loss + metrics["consistent_loss"]
        if use["local"]:
            metrics["local_mi_g"] = local_term(ds["local_discriminator"], high, b,
                                               draws["local"]) * w["local"]
            loss = loss + metrics["local_mi_g"]
        if use["domain"]:
            metrics["domain_g"] = domain_g_loss(ds["domain_discriminator"], low,
                                                1.0 - b["is_h36m"]) * w["domain"]
            loss = loss + metrics["domain_g"]
        if use["heatmap"] and parity == 1:
            metrics["hmi_g"] = heatmap_term(ds["heatmap_discriminator"], low, output,
                                            draws["heatmap"], w["heatmap"])
            loss = loss + metrics["hmi_g"]
        if use["view"] or use["joints"] or use["fund"]:
            j2d = joints2d_of(output, b)
            frac = b["is_h36m"].mean()
            if use["fund"]:
                metrics["fund_loss"] = fund_term(j2d, b)
                loss = loss + metrics["fund_loss"]
            if use["view"] and parity == 1:
                metrics["vmi_g"] = view_mi_loss(ds["view_discriminator"], j2d, view1_num,
                                                view_measure) * frac * w["view"]
                loss = loss + metrics["vmi_g"]
            if use["joints"] and parity == 1:
                metrics["jmi_g"] = (joints_term(ds["joints_discriminator"], j2d) * frac
                                    * w["joints"])
                loss = loss + metrics["jmi_g"]
        metrics["loss"] = loss
        return loss, output, metrics

    def grad_norm_probe(ds, feats, b, draws, parity):
        """Per-term gradient norms with respect to the raw heatmaps
        (function.py:352-362): MSE, fundamental and the parity's generator
        MI terms. The fused heatmaps and the features are held fixed, as the
        JAX step's probe holds them."""
        _, fused0, low0, _ = (t.detach() for t in feats)
        frac = b["is_h36m"].mean()
        out_of = lambda r: routed(r, fused0, b)  # noqa: E731
        terms = {"mse": lambda r: mse_term(r, out_of(r), b)}
        if use["fund"]:
            terms["fund"] = lambda r: fund_term(joints2d_of(out_of(r), b), b)
        if use["heatmap"] and parity == 1:
            terms["hmi_g"] = lambda r: heatmap_term(ds["heatmap_discriminator"], low0, out_of(r),
                                                    draws["heatmap"], w["heatmap"])
        if use["view"] and parity == 1:
            terms["vmi_g"] = lambda r: view_mi_loss(
                ds["view_discriminator"], joints2d_of(out_of(r), b), view1_num,
                view_measure) * frac * w["view"]
        if use["joints"] and parity == 1:
            terms["jmi_g"] = lambda r: joints_term(
                ds["joints_discriminator"], joints2d_of(out_of(r), b)) * frac * w["joints"]
        return grad_norms_wrt_heatmaps(terms, feats[0])

    # --------------------------------------------------------- full step

    def step(states: dict, batch, epoch_parity: int = 0, draws=None):
        if epoch_parity not in (0, 1):
            raise ValueError(f"epoch_parity must be 0 or 1, got {epoch_parity}")
        b = _on(batch, dev)
        base = states["base_model"]
        net = base.params
        d_names = [n for n in states if n != "base_model"]
        ds = {n: states[n].params for n in d_names}
        for m in (net, *ds.values()):
            m.train()
            m.zero_grad(set_to_none=True)

        # one base forward: the critics read it detached, the generator's
        # gradients run back through its graph
        with sync_batch_stats(mesh):
            raw, fused, low, high = net(b["images"])
        if mesh is not None:
            raw, fused, low, high = (gather_rows(t, mesh, live=True)
                                     for t in (raw, fused, low, high))
            b = gather_rows({k: v for k, v in b.items() if k != "images"}, mesh)
        feats = (raw, raw if fused is None else fused, low, high)
        draws = (sample_draws(b, cfg, epoch_parity, generator) if draws is None
                 else _to(draws, dev))

        d_total, metrics = d_losses(ds, feats, b, draws["d"], epoch_parity)
        if isinstance(d_total, torch.Tensor) and d_total.requires_grad:
            d_total.backward()
        for n in d_names:
            tx_disc[n].update(ds[n], states[n].opt_state)

        with _frozen(ds.values()):
            loss, output, g_metrics = g_loss(ds, feats, b, draws["g"], epoch_parity)
            loss.backward()
            if mesh is not None:
                all_reduce_grads(net, mesh)
            metrics.update(g_metrics)
            if watch_grad:
                for k, v in grad_norm_probe(ds, feats, b, draws["g"], epoch_parity).items():
                    metrics[f"grad_norm_{k}"] = v
        tx_base.update(net, base.opt_state)

        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            metrics["acc"] = _acc(output, b["target"])
        return {n: dataclasses.replace(st, step=st.step + 1) for n, st in states.items()}, metrics

    return step


def init_discriminator_states(disc_models: dict, tx_disc: dict, device=None) -> dict:
    """{name: TrainState} of the critics (models/discriminators.py's
    ``build_discriminators``, their weights as built): each module moved to
    the device, ``tx_disc[name]``'s fresh state, step 0. CUDA unless
    ``device`` is given."""
    dev = resolve_device(device)
    return {n: TrainState(m.to(dev), tx_disc[n].init(m), 0) for n, m in disc_models.items()}
