"""The supervised train step and the eval step.

The reference's inner loop (lib/core/function.py:148-367) runs Python loops
over views with host-side metrics; here one call takes the whole
``[N, V, ...]`` batch, autograd gives the gradients and train/optim.py the
update, and the metrics stay 0-d tensors on the device (reading one waits
for the step).

The objective is the reference's intended loss, MSE on the raw heatmaps
plus MSE on the fused output, not the accumulator slip at
function.py:184-188 that adds the raw term twice when aggregation is on.
Heatmaps are channels-last [N, V, h, w, J], as the model returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from posetpu_torch import resolve_device
from posetpu_torch.core.evaluate import pck_accuracy
from posetpu_torch.core.inference import final_preds, flip_test_merge, fuse_routing
from posetpu_torch.core.losses import consistency_loss, fundamental_loss, joints_mse_loss
from posetpu_torch.models.multiview import aggregate
from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform
from posetpu_torch.ops.heatmap import soft_argmax_2d
from posetpu_torch.parallel.batchnorm import sync_batch_stats
from posetpu_torch.parallel.mesh import all_reduce_grads, check_mesh, gather_rows
from posetpu_torch.train.state import TrainState
from posetpu_torch.utils.gradients import grad_norms_wrt_heatmaps
from posetpu_torch.utils.profiling import span


def _integral_joints_image_coords(output, center, scale, heatmap_size):
    """Soft-argmax in heatmap coords, mapped to source-image coords
    (generate_integral_preds_2d_th + transform_back_th,
    lib/utils/transforms.py:149-198). output [N, V, h, w, J]."""
    coords = soft_argmax_2d(output.movedim(-1, 2))  # [N, V, J, 2]
    inv = get_affine_transform(center, scale, 0.0, heatmap_size, inv=True)
    return affine_transform_points(coords, inv.to(coords.dtype))


def _on(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _jhw(t):
    """[..., h, w, J] -> [..., J, h, w]."""
    return t.movedim(-1, -3)


def _acc(output, target):
    """PCK of the [N, V, h, w, J] output against the target, per view."""
    n, v = output.shape[:2]
    flat = lambda t: _jhw(t).reshape((n * v,) + _jhw(t).shape[2:])
    return pck_accuracy(flat(output), flat(target))[1]


def make_train_step(model, cfg, tx, mesh=None, device=None) -> Callable:
    """The supervised train step: MSE, and from ``cfg.LOSS`` the consistency
    and fundamental losses and the grad-norm probe (the adversarial MI
    losses are train/gan.py's).

    ``train_step(state, batch) -> (state, metrics)`` runs ``state.params``
    (a MultiViewPose like ``model``) in training mode, back-propagates and
    lets ``tx`` (train/optim.py) update the parameters in place. batch:
    images [N, V, H, W, 3], target [N, V, h, w, J], weight [N, V, J],
    is_h36m [N], center and scale [N, V, 2], and for the fundamental loss
    fmats [N, 12, 3, 3]; arrays or tensors, moved to the device. Metrics:
    loss, mse_loss, consistent_loss, fund_loss, acc (PCK on the routed
    output, as the reference, function.py:463-466) and grad_norm_*.

    With ``mesh`` (parallel/mesh.data_mesh) each rank takes its own rows
    of the global batch: BatchNorm's moments are the global batch's, the
    heatmaps are gathered (this rank's rows live, the others' detached), so
    every rank computes the global batch's losses and metrics and
    back-propagates its share of the gradient; one all-reduce a dtype sums
    the shares and every rank steps the same optimizer on the same bytes.

    CUDA unless ``device`` is given (under a mesh, the mesh's device)."""
    check_mesh(mesh, "make_train_step")
    dev = resolve_device(device if mesh is None else mesh.device)
    is_aggre = bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None
    fuse_output = bool(cfg.TEST.FUSE_OUTPUT)
    use_consistent = bool(cfg.LOSS.USE_CONSISTENT_LOSS)
    use_fund = bool(cfg.LOSS.USE_FUNDAMENTAL_LOSS)
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    use_tw_fund = bool(cfg.LOSS.USE_TARGET_WEIGHT_FUND)
    watch_grad = bool(cfg.LOSS.WATCH_GRAD_NORM)
    mse_w = float(cfg.LOSS.MSE_LOSS_WEIGHT)
    cons_w = float(cfg.LOSS.CONSISTENT_LOSS_WEIGHT)
    fund_w = float(cfg.LOSS.FUNDAMENTAL_LOSS_WEIGHT)
    hm_size = (int(cfg.NETWORK.HEATMAP_SIZE[0]), int(cfg.NETWORK.HEATMAP_SIZE[1]))

    def routed(raw, fused, b):
        return fuse_routing(raw, fused, b["is_h36m"]) if (is_aggre and fuse_output) else raw

    def mse_term(raw, output, b):
        tw = b["weight"] if use_tw else None
        m = joints_mse_loss(raw, b["target"], tw) * raw.shape[1] * mse_w
        if is_aggre:
            m = m + joints_mse_loss(output, b["target"], tw) * raw.shape[1] * mse_w
        return m

    def fund_term(output, b):
        j2d = _integral_joints_image_coords(output, b["center"], b["scale"], hm_size)
        fl = fundamental_loss(j2d, b["weight"], b["fmats"], sample_mask=b["is_h36m"],
                              use_target_weight=use_tw_fund)
        # the reference normalises by the h36m subset's size (loss.py:132)
        return fl * (j2d.shape[0] / torch.clamp(b["is_h36m"].sum(), min=1.0)) * fund_w

    def forward(net, b):
        """The heatmaps of the global batch, and the batch itself."""
        with sync_batch_stats(mesh):
            raw, fused, _, _ = net(b["images"])
        if mesh is None:
            return raw, fused, b
        rest = gather_rows({k: v for k, v in b.items() if k != "images"}, mesh)
        return gather_rows(raw, mesh, live=True), gather_rows(fused, mesh, live=True), rest

    def loss_fn(raw, fused, b):
        output = routed(raw, fused, b)
        loss = mse_term(raw, output, b)
        metrics = {"mse_loss": loss}
        if is_aggre and use_consistent:
            metrics["consistent_loss"] = consistency_loss(raw, fused, b["is_h36m"]) * cons_w
            loss = loss + metrics["consistent_loss"]
        if use_fund:
            metrics["fund_loss"] = fund_term(output, b)
            loss = loss + metrics["fund_loss"]
        metrics["loss"] = loss
        return loss, output, raw, metrics

    def grad_norm_probe(net, raw, b):
        """Per-term gradient norms with respect to the raw heatmaps
        (function.py:352-362): the aggregation (in f32, as the JAX package's
        probe builds it) and the losses again per term; the backbone is not
        run again."""
        bank = net.aggre_layer.weight.detach() if is_aggre else None

        def downstream(r):
            fused = aggregate(r, bank) if is_aggre else None
            return fused, routed(r, fused, b)

        terms = {"mse": lambda r: mse_term(r, downstream(r)[1], b)}
        if is_aggre and use_consistent:
            terms["consistent"] = lambda r: consistency_loss(
                r, downstream(r)[0], b["is_h36m"]) * cons_w
        if use_fund:
            terms["fund"] = lambda r: fund_term(downstream(r)[1], b)
        return grad_norms_wrt_heatmaps(terms, raw)

    def train_step(state: TrainState, batch):
        with span("train.step"):
            net = state.params
            net.train()
            net.zero_grad(set_to_none=True)
            with span("train.forward"):
                raw, fused, b = forward(net, _on(batch, dev))
            with span("train.loss"):
                loss, output, raw, metrics = loss_fn(raw, fused, b)
            with span("train.backward"):
                loss.backward()
            if mesh is not None:
                with span("train.all_reduce"):
                    all_reduce_grads(net, mesh)
            if watch_grad:
                with span("train.grad_probe"):
                    for k, v in grad_norm_probe(net, raw, b).items():
                        metrics[f"grad_norm_{k}"] = v
            with span("train.optimizer"):
                tx.update(net, state.opt_state)
            with span("train.metrics"), torch.no_grad():
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["acc"] = _acc(output, b["target"])
            return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(model, cfg, flip_pairs=None, mesh=None, device=None) -> Callable:
    """The eval step, the device side of validate() (function.py:557-644):
    the forward (with ``cfg.TEST.FLIP_TEST`` the mirrored images folded into
    the same batch), fuse routing, the flip-test merge, the losses
    (function.py:596-609), PCK and final predictions (the B7 decode on a
    CUDA tensor).

    ``eval_step(params, batch) -> dict``: params a MultiViewPose like
    ``model`` (``state.params``), run in eval mode; returns loss, acc, preds
    [N, V, J, 2] in source-image pixels, maxvals [N, V, J] and heatmaps
    [N, V, h, w, J].

    With ``mesh`` each rank runs its own rows (parallel/mesh.shard_batch);
    the heatmaps, preds and maxvals of every rank are gathered in rank
    order, and the losses and PCK are the global batch's, the same on every
    rank (JAX's replicated ``out_shardings``). CUDA unless ``device`` is
    given (under a mesh, the mesh's device)."""
    check_mesh(mesh, "make_eval_step")
    dev = resolve_device(device if mesh is None else mesh.device)
    is_aggre = bool(cfg.NETWORK.AGGRE) and model.aggre_layer is not None
    fuse_output = bool(cfg.TEST.FUSE_OUTPUT)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift = bool(cfg.TEST.SHIFT_HEATMAP)
    post = bool(cfg.TEST.POST_PROCESS)
    use_tw = bool(cfg.LOSS.USE_TARGET_WEIGHT)
    use_consistent = bool(cfg.LOSS.USE_CONSISTENT_LOSS)
    pseudo_mse = bool(cfg.DATASET.PSEUDO_LABEL_PATH)
    mse_w = float(cfg.LOSS.MSE_LOSS_WEIGHT)
    pairs = tuple(tuple(p) for p in (flip_pairs or ()))

    def routed(raw, fused, mask):
        return fuse_routing(raw, fused, mask) if (is_aggre and fuse_output) else raw

    @torch.no_grad()
    def eval_step(params, batch):
        params.eval()
        b = _on(batch, dev)
        is_h36m = b["is_h36m"]
        if flip_test:
            # one forward at 2N groups (the reference runs a second one,
            # function.py:570-571)
            n = b["images"].shape[0]
            raw2, fused2, _, _ = params(torch.cat([b["images"], b["images"].flip(-2)]))
            out2 = routed(raw2, fused2, torch.cat([is_h36m, is_h36m]))
            raw = raw2[:n]
            fused = None if fused2 is None else fused2[:n]
            output = flip_test_merge(_jhw(out2[:n]), _jhw(out2[n:]), pairs,
                                     shift=shift).movedim(-3, -1)
        else:
            raw, fused, _, _ = params(b["images"])
            output = routed(raw, fused, is_h36m)
        preds, maxvals = final_preds(_jhw(output), b["center"], b["scale"], post_process=post)
        if mesh is not None:
            raw, fused, output, preds, maxvals = (gather_rows(t, mesh) for t in (
                raw, fused if is_aggre and (use_consistent or pseudo_mse) else None, output,
                preds, maxvals))
            b = gather_rows({k: b[k] for k in ("target", "weight", "is_h36m")}, mesh)
            is_h36m = b["is_h36m"]
        tw = b["weight"] if use_tw else None
        loss = joints_mse_loss(raw, b["target"], tw) * raw.shape[1]
        if is_aggre and use_consistent and fused is not None:
            loss = loss + consistency_loss(raw, fused, is_h36m)
        if is_aggre and pseudo_mse:
            loss = loss + joints_mse_loss(output, b["target"], tw) * raw.shape[1] * mse_w
        return {"loss": loss, "acc": _acc(output, b["target"]), "preds": preds,
                "maxvals": maxvals, "heatmaps": output}

    return eval_step


def init_train_state(model, tx, device=None) -> TrainState:
    """The train state of ``model`` (a MultiViewPose, its weights as built):
    the module moved to the device, ``tx``'s fresh state, step 0. CUDA
    unless ``device`` is given."""
    model = model.to(resolve_device(device))
    return TrainState(model, tx.init(model), 0)
