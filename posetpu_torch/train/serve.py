"""The int8 serving-side evaluation step.

Runs the PTQ (or QAT) int8 trunk of models/quant.py inside the contract of
train/step.make_eval_step: multi-view batches, the optional aggregation
fusion (kept in bf16: one product over float-trained weights), fuse
routing, the flip test in the same batch, and the decode to source-image
coordinates (the B7 kernel on the card). ``python -m
posetpu_torch.cli.validate --int8`` serves checkpoints through it.
"""

from __future__ import annotations

from typing import Callable

import torch

from posetpu_torch import resolve_device
from posetpu_torch.core.inference import final_preds, flip_test_merge, fuse_routing
from posetpu_torch.models.multiview import aggregate
from posetpu_torch.models.pose_resnet import get_pose_net
from posetpu_torch.models.quant import quantize_pose_resnet
from posetpu_torch.train.qat import quantize_pose_resnet_qat
from posetpu_torch.train.step import _jhw, _on


def make_quant_eval_step(qfwd, cfg, flip_pairs=None, has_aggre: bool = False,
                         device=None) -> Callable:
    """``qfwd`` from quantize_pose_resnet (or its QAT twin). The returned
    ``eval_step(qvars, batch) -> dict`` takes ``qvars = {"q": qparams,
    "bank": the [12, S, S] aggregation bank or None}`` and returns loss and
    acc (0: the serving path computes no training loss), preds [N, V, J, 2]
    in source-image pixels, maxvals [N, V, J] and heatmaps [N, V, h, w, J].
    With ``cfg.TEST.FLIP_TEST`` the mirrored images go through the trunk in
    the same batch. The bank's product runs in bf16, as the JAX package's.
    CUDA unless ``device`` is given."""
    dev = resolve_device(device)
    fuse = bool(has_aggre) and bool(cfg.TEST.FUSE_OUTPUT)
    flip_test = bool(cfg.TEST.FLIP_TEST)
    shift = bool(cfg.TEST.SHIFT_HEATMAP)
    post = bool(cfg.TEST.POST_PROCESS)
    pairs = tuple(tuple(p) for p in (flip_pairs or ()))

    def trunk(qparams, x):
        n, v = x.shape[:2]
        hm = qfwd(qparams, x.reshape((n * v,) + x.shape[2:]))
        return hm.reshape((n, v) + hm.shape[1:])

    def routed(qvars, raw, is_h36m):
        if not fuse:
            return raw
        return fuse_routing(raw, aggregate(raw, qvars["bank"], torch.bfloat16), is_h36m)

    @torch.no_grad()
    def eval_step(qvars, batch):
        b = _on(batch, dev)
        images, is_h36m = b["images"], b["is_h36m"]
        if flip_test:
            n = images.shape[0]
            out2 = routed(qvars, trunk(qvars["q"], torch.cat([images, images.flip(-2)])),
                          torch.cat([is_h36m, is_h36m]))
            output = flip_test_merge(_jhw(out2[:n]), _jhw(out2[n:]), pairs,
                                     shift=shift).movedim(-3, -1)
        else:
            output = routed(qvars, trunk(qvars["q"], images), is_h36m)
        preds, maxvals = final_preds(_jhw(output), b["center"], b["scale"], post_process=post)
        zero = torch.zeros((), device=dev)
        return {"loss": zero, "acc": zero, "preds": preds, "maxvals": maxvals,
                "heatmaps": output}

    return eval_step


def build_quant_from_variables(cfg, variables, calib_batches, qat_batches=None,
                               qat_lr: float = 3e-6, subpixel_deconvs=False, act4=(),
                               device=None):
    """Quantize the ResNet trunk of a MultiViewPose's variables ({"params",
    "batch_stats"}: state-dict entries, as cli/common.load_model_variables
    gives them). Returns (qparams, qfwd, bank or None): pass ``{"q":
    qparams, "bank": bank}`` to the eval step. The bank (where
    ``NETWORK.AGGRE`` and the variables hold one) comes back in bf16 on the
    device, the dtype its product runs in. CUDA unless ``device`` is given.

    ``qat_batches``: [N, H, W, 3] image batches; when given, the folded
    weights are distillation-QAT fine-tuned (train/qat.py) before the int8
    conversion instead of plain PTQ.

    ``subpixel_deconvs``: a bool or a set of deconv names quantized in the
    per-phase subpixel form (finer per-phase weight scales). PTQ only:
    refused with ``qat_batches``.

    ``act4``: boundary names stored at 4 bits (the s4 carrier, as the JAX
    package passes). PTQ only: with ``qat_batches`` it is not applied, as in
    the JAX package."""
    dev = resolve_device(device)
    resnet = get_pose_net(cfg, dtype=torch.float32)
    resnet.load_state_dict({k[len("resnet."):]: v for part in ("params", "batch_stats")
                            for k, v in variables[part].items() if k.startswith("resnet.")})
    resnet.eval()
    if qat_batches:
        if subpixel_deconvs:
            raise ValueError("subpixel_deconvs is PTQ-only: QAT runs the dilated deconvs")
        qparams, qfwd, _ = quantize_pose_resnet_qat(resnet, calib_batches, qat_batches,
                                                    lr=qat_lr, device=dev)
    else:
        qparams, qfwd = quantize_pose_resnet(resnet, calib_batches,
                                             subpixel_deconvs=subpixel_deconvs, act4=act4,
                                             act4_mode="s4", device=dev)
    bank = variables["params"].get("aggre_layer.weight")
    if not cfg.NETWORK.AGGRE or bank is None:
        return qparams, qfwd, None
    return qparams, qfwd, bank.to(dev, torch.bfloat16)
