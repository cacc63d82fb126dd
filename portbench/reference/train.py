"""The plain reference of the supervised training step: the losses of the
reference (``lib/core/loss.py``, ``lib/core/function.py``) and Adam as
optax computes it, in plain PyTorch over :mod:`portbench.reference.model`.

Loss: the joints' heatmap MSE (each joint's mean of ``(w (pred - gt))^2``
over the batch, views and pixels, summed over the joints) times the number
of views, on the raw maps and, where the model fuses, on the routed output
too; with the consistency loss, 0.01 times the mean of ``(raw - fused)^2``
over the H36M groups. Adam: b1 0.9, b2 0.999, eps 1e-8, the bias-corrected
moments, the learning rate constant over the steps followed here.
"""

from __future__ import annotations

import torch

from portbench.reference import model as M

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def joints_mse(output, target, weight):
    d = (output - target) * weight[..., None, None, :]
    return (d * d).mean(dim=tuple(range(d.dim() - 1))).sum()


def loss(w, batch, cfg: dict, cast=None, checkpoint: bool = False):
    """(loss, new running averages, [raw heatmaps, fused heatmaps or
    nothing]) of one batch in training mode."""
    raw, fused, stats = M.forward(w, batch["images"], cfg, train=True, cast=cast,
                                  checkpoint=checkpoint)
    views = raw.shape[1]
    total = joints_mse(raw, batch["target"], batch["weight"]) * views
    if fused is not None:
        out = M.route(raw, fused, batch["is_h36m"])
        total = total + joints_mse(out, batch["target"], batch["weight"]) * views
        if cfg["consistent_loss"]:
            se = (raw - fused) ** 2
            m = batch["is_h36m"].to(se.dtype).reshape(-1, 1, 1, 1, 1)
            denom = torch.clamp(m.sum() * se[0].numel(), min=1.0)
            total = total + cfg["consistent_loss_weight"] * (se * m).sum() / denom
    return total, stats, [raw] + ([] if fused is None else [fused])


def follow(weights: dict, batches, cfg: dict, lr: float, cast=None, checkpoint: bool = False):
    """Train ``len(batches)`` steps from ``weights`` (not modified). Returns
    {"losses": [float], "grad1": {name: first gradient}, "maps1": the
    first step's heatmaps (raw, and fused where the model fuses), "stats1":
    {name: running averages after the first step}, "params":
    {name: parameters after the last step}, "stats": {name: running
    averages after the last step}}, every parameter trainable. ``checkpoint``: see
    :func:`portbench.reference.model.pose_resnet`."""
    stat_names = [n for n in weights if n.endswith(("running_mean", "running_var"))]
    params = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()
              if n not in stat_names}
    stats = {n: weights[n].detach().clone() for n in stat_names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    out = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        value, new_stats, maps = loss({**params, **stats}, batch, cfg, cast, checkpoint)
        names = list(params)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        out["losses"].append(float(value.detach()))
        if step == 1:
            out["grad1"] = {n: g.detach().clone() for n, g in zip(names, grads)}
            out["maps1"] = [t.detach().float() for t in maps]
            out["stats1"] = {n: t.detach().clone() for n, t in new_stats.items()}
        bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
        with torch.no_grad():
            for n, g in zip(names, grads):
                mu[n].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + ADAM_EPS)
                params[n].sub_(lr * upd)
        stats.update({n: t.detach() for n, t in new_stats.items()})
        del value, grads, maps
    out["params"] = {n: p.detach() for n, p in params.items()}
    out["stats"] = stats
    return out
