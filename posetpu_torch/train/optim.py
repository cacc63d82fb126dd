"""Optimizers and learning-rate schedules, as optax computes them.

The reference's get_optimizer (lib/utils/utils.py:62-85) with its per-model
MultiStepLR (run/pose2d/train.py:289-292): Adam (the default, lr 1e-3) or
SGD with momentum, decayed stepwise at the configured epochs; a learning
rate of its own for discriminators; ``FIX_BACKBONE`` trains only the
aggregation bank (utils.py:64-67).

For a ViTPose backbone, ``adamw``: ViTPose's recipe (mmcv's AdamW with
``LayerDecayOptimizerConstructor``, ``grad_clip`` and a linear warm-up by
iterations): the gradient clipped at a global L2 norm, Adam's direction
and a decoupled weight decay on every parameter of two or more
dimensions but ``pos_embed``, each parameter's rate scaled by its layer.

The JAX package builds these from optax, so the arithmetic here is optax's
and not ``torch.optim``'s: Adam's update is the bias-corrected
``mu_hat / (sqrt(nu_hat + eps_root) + eps)`` times the schedule's value at
the step count before the increment, with ``mu`` stored in ``mu_dtype``
(``TRAIN.ADAM_MU_DTYPE``) beside f32 parameters; the schedule is evaluated
in f32, the bias corrections in the gradients' precision. The updates run
as ``torch._foreach_*`` passes over all parameters at once.
"""

from __future__ import annotations

import numpy as np
import torch

from posetpu_torch.utils.profiling import span


def multistep_lr(base_lr: float, lr_step, lr_factor: float, steps_per_epoch: int,
                 warmup_epochs: int = 0):
    """MultiStepLR: ``base_lr`` times ``lr_factor`` for each boundary epoch
    reached (a step count ``>= epoch * steps_per_epoch``). ``warmup_epochs``
    > 0 puts a linear 0 -> base_lr ramp first (TRAIN.WARMUP_EPOCHS, off by
    default; the reference has none), after which the steps count from the
    ramp's end (optax.join_schedules). Returns count -> np.float32."""
    boundaries = sorted((int(e) * steps_per_epoch, lr_factor) for e in lr_step)

    def multistep(count):
        v = np.float32(base_lr)
        for b, factor in boundaries:
            if count >= b:
                v = np.float32(factor) * v
        return v

    if not warmup_epochs:
        return multistep
    warm = int(warmup_epochs) * steps_per_epoch

    def schedule(count):
        if count >= warm:
            return multistep(count - warm)
        frac = np.float32(1) - np.float32(min(max(count, 0), warm)) / np.float32(warm)
        return np.float32(-base_lr) * frac + np.float32(base_lr)

    return schedule


def linear_warmup(schedule, iters: int, ratio: float):
    """``schedule`` under mmcv's linear warm-up by iterations: at count i <
    ``iters`` its value times ``1 - (1 - i / iters) * (1 - ratio)``, from
    ``ratio`` of the rate to all of it. ``iters`` 0: ``schedule`` itself."""
    if not iters:
        return schedule

    def warmed(count):
        v = schedule(count)
        if count >= iters:
            return v
        k = (np.float32(1) - np.float32(count) / np.float32(iters)) * np.float32(1 - ratio)
        return v * (np.float32(1) - k)

    return warmed


class Optimizer:
    """Adam (optax.adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0) or SGD with
    momentum (optax.sgd: ``trace = g + momentum * trace``) over a module's
    named parameters, those for which ``trainable(name)`` holds; the others
    get no update at all (optax.set_to_zero). ``mu_dtype``: Adam's first
    moment's dtype (None: each parameter's own).

    ``init(model)`` -> the optimizer state {"count", "mu", "nu"} (Adam) or
    {"count", "trace"} (SGD), each a dict by parameter name;
    ``update(model, state)`` takes one step from the parameters' ``.grad``,
    in place. A trainable parameter whose ``.grad`` is None steps as on a
    zero gradient, as optax steps the zeros ``jax.grad`` gives it: the
    moments and the count still advance, and a nonzero first moment still
    moves the parameter.

    ``adamw`` (torch's AdamW, as ViTPose trains): Adam's direction, and
    each parameter p of two or more dimensions but ``pos_embed`` moves by
    ``-lr_p * (direction + weight_decay * p)`` (the others by ``-lr_p *
    direction``), ``lr_p`` the schedule's value times ``lr_scale(name)``.
    ``clip_norm`` > 0 (any kind): the gradients first multiplied by
    ``min(1, clip_norm / (norm + 1e-6))``, ``norm`` their global L2 norm
    (``torch.nn.utils.clip_grad_norm_``), in place."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, kind: str, schedule, *, mu_dtype=None,
                 momentum: float = 0.9, nesterov: bool = False, trainable=None,
                 weight_decay: float = 0.0, lr_scale=None, clip_norm: float = 0.0):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind, self.schedule = kind, schedule
        self.mu_dtype, self.momentum, self.nesterov = mu_dtype, momentum, nesterov
        self.trainable = trainable or (lambda name: True)
        self.weight_decay, self.clip_norm = float(weight_decay), float(clip_norm)
        self.lr_scale = lr_scale or (lambda name: 1.0)

    def _params(self, model):
        return {n: p for n, p in model.named_parameters() if self.trainable(n)}

    def init(self, model) -> dict:
        ps = self._params(model)
        zeros = lambda dtype=None: {n: torch.zeros_like(p, dtype=dtype) for n, p in ps.items()}
        if self.kind in ("adam", "adamw"):
            return {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros()}
        return {"count": 0, "trace": zeros()}

    @torch.no_grad()
    def update(self, model, state: dict) -> None:
        ps = self._params(model)
        params = list(ps.values())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if self.clip_norm > 0:
            with span("train.clip"):
                clip_grads_(grads, self.clip_norm)
        lr = float(self.schedule(state["count"]))
        state["count"] += 1
        if self.kind in ("adam", "adamw"):
            step = self._adam(grads, [state["mu"][n] for n in ps],
                              [state["nu"][n] for n in ps], state["count"])
        else:
            trace = [state["trace"][n] for n in ps]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)  # g + momentum * trace
            step = trace
            if self.nesterov:
                step = torch._foreach_mul(trace, self.momentum)
                torch._foreach_add_(step, grads)
            else:
                step = [t.clone() for t in trace]
        if self.kind == "adamw":
            decayed = [i for i, (n, p) in enumerate(ps.items())
                       if p.dim() > 1 and not n.endswith("pos_embed")]
            if self.weight_decay and decayed:  # the decay joins the direction
                torch._foreach_add_([step[i] for i in decayed], [params[i] for i in decayed],
                                    alpha=self.weight_decay)
            torch._foreach_mul_(step, [-lr * float(self.lr_scale(n)) for n in ps])
        else:
            torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)

    def _adam(self, grads, mu, nu, count):
        """The bias-corrected Adam direction; ``mu`` and ``nu`` advanced in
        place. optax multiplies a bf16 ``mu`` by b1 rounded to bf16 (a weak
        Python float takes the array's dtype), and adds in f32."""
        b1, b2 = self.B1, self.B2
        b1_mu = b1 if self.mu_dtype is None else float(torch.tensor(b1, dtype=self.mu_dtype))
        m = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m, torch._foreach_mul(mu, b1_mu))  # (1-b1) g + b1 mu, in f32
        torch._foreach_copy_(mu, m)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        # 1 - b**count in the gradients' precision: f32, or f64 as optax under
        # JAX's x64 (in f32, 1 - b2 is 1.3e-5 off 1e-3)
        dt = np.float64 if any(g.dtype == torch.float64 for g in grads) else np.float32
        bc1 = float(dt(1) - dt(b1) ** dt(count))
        bc2 = float(dt(1) - dt(b2) ** dt(count))
        torch._foreach_div_(m, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        torch._foreach_div_(m, den)
        return m


def clip_grads_(grads, max_norm: float):
    """``grads`` times ``min(1, max_norm / (norm + 1e-6))`` in place, ``norm``
    their global L2 norm (returned, a 0-d tensor): ``clip_grad_norm_``'s
    arithmetic, without a wait on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + 1e-6), max=1.0))
    return norm


def make_optimizer(cfg, steps_per_epoch: int, discriminator: bool = False,
                   fix_backbone: bool | None = None) -> Optimizer:
    """The optimizer of the base model (or, with ``discriminator``, of a
    discriminator) from ``cfg.TRAIN``: OPTIMIZER, LR (LR_DISCRIMINATOR),
    LR_STEP, LR_FACTOR, WARMUP_EPOCHS, WARMUP_ITERS and WARMUP_RATIO,
    ADAM_MU_DTYPE, MOMENTUM, NESTEROV, WD, LAYER_DECAY and CLIP_GRAD_NORM,
    and FIX_BACKBONE (only ``aggre_layer`` parameters train). ``adamw``
    decays no ``pos_embed``; with a ViTPose backbone (``BACKBONE_MODEL:
    vitpose``) LAYER_DECAY scales each base-model parameter's rate by
    ``LAYER_DECAY ** (DEPTH + 1 - layer)`` (models/vitpose.layer_id)."""
    t = cfg.TRAIN
    lr = t.LR_DISCRIMINATOR if discriminator else t.LR
    schedule = multistep_lr(lr, t.LR_STEP, t.LR_FACTOR, steps_per_epoch,
                            warmup_epochs=int(getattr(t, "WARMUP_EPOCHS", 0)))
    schedule = linear_warmup(schedule, int(t.WARMUP_ITERS), float(t.WARMUP_RATIO))
    fix = t.FIX_BACKBONE if fix_backbone is None else fix_backbone
    trainable = None
    if fix and not discriminator:
        trainable = lambda name: "aggre_layer" in name.split(".")
    clip = float(t.CLIP_GRAD_NORM)
    if t.OPTIMIZER == "adam":
        mu_dtype = getattr(t, "ADAM_MU_DTYPE", "float32")
        return Optimizer("adam", schedule, trainable=trainable, clip_norm=clip,
                         mu_dtype=None if mu_dtype == "float32" else getattr(torch, mu_dtype))
    if t.OPTIMIZER == "adamw":
        lr_scale = None
        if cfg.BACKBONE_MODEL == "vitpose" and not discriminator and float(t.LAYER_DECAY) != 1:
            from posetpu_torch.models.vitpose import layer_id

            depth, rate = int(cfg.POSE_VIT.DEPTH), float(t.LAYER_DECAY)
            lr_scale = lambda name: rate ** (depth + 1 - layer_id(name, depth))
        return Optimizer("adamw", schedule, trainable=trainable, clip_norm=clip,
                         weight_decay=float(t.WD), lr_scale=lr_scale)
    if t.OPTIMIZER == "sgd":
        return Optimizer("sgd", schedule, momentum=t.MOMENTUM, clip_norm=clip,
                         nesterov=bool(t.NESTEROV), trainable=trainable)
    raise ValueError(f"unknown optimizer {t.OPTIMIZER}")
