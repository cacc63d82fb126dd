"""Seeded weights of ViTPose and the fusion bank, made on the device in a
few large calls, by the names of :func:`portbench.reference.vitpose.param_spec`.

The trunk at its published init (Xu et al. 2022, ``init_weights`` of the
ViT backbone): every Linear weight and ``pos_embed`` N(0, 0.02) (the
published trunc-normal cuts at +-2, a hundred deviations out), biases 0,
LayerNorm 1 and 0, the patch embedding PyTorch's Conv2d default
(U(+-1 / sqrt(fan-in)) for its kernel and bias). The head as the ResNet
cells' (:mod:`portbench.weights`): deconvolution kernels He-scaled (fan-in
the input channels times four taps), BatchNorm scales 1 + 0.1 N(0, 1),
shifts and running means 0.1 N(0, 1), running variances 1 + 0.05 |N(0, 1)|,
the last convolution He-scaled with a zero bias and then divided by the
largest |heatmap| of a probe through the plain reference in training mode
(no drop path), so the heatmaps span [-1, 1]; the bank U(0, 0.1). The
published head init, N(0, 0.001) everywhere, would leave the heatmaps a
thousandth of the targets, and the losses blind to the trunk.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import model as M
from portbench.reference import vitpose as V
from portbench.weights import generator

UNIFORM = ("patch.weight", "patch.bias", "bank")


def make(cfg: dict, seed: int, device, probe=None, head_scale: float | None = None):
    """(weights {name: f32 tensor on ``device``}, head scale). ``probe``:
    normalised images [N, H, W, 3] for the head rescale, unless
    ``head_scale`` (the factor an earlier call returned) is given."""
    spec = V.param_spec(cfg)
    gen = generator(seed, 0, device)
    normal = [(n, s, r) for n, s, r in spec if r not in UNIFORM]
    sizes = [torch.Size(s).numel() for _, s, _ in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    w = {}
    for (name, shape, role), r in zip(normal, flat.split(sizes)):
        r = r.view(shape)
        if role in ("pos", "linear.weight"):
            w[name] = 0.02 * r
        elif role == "deconv":
            w[name] = r * (2.0 / (shape[0] * 4)) ** 0.5
        elif role == "head.weight":
            w[name] = r * (2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
        elif role == "bn.weight":
            w[name] = 1.0 + 0.1 * r
        elif role == "bn.var":
            w[name] = 1.0 + 0.05 * r.abs()
        elif role in ("bn.bias", "bn.mean"):
            w[name] = 0.1 * r
        elif role == "ln.weight":
            w[name] = torch.ones(shape, device=device)
        else:  # Linear, LayerNorm and head biases
            w[name] = torch.zeros(shape, device=device)
    del flat
    fan_in = 3 * cfg["patch_size"] ** 2
    for name, shape, role in spec:
        if role in ("patch.weight", "patch.bias"):
            bound = 1.0 / math.sqrt(fan_in)
            w[name] = torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)
        elif role == "bank":
            w[name] = torch.empty(shape, device=device).uniform_(0.0, 0.1, generator=gen)
    if head_scale is None:
        with M.full_f32(), torch.no_grad():
            hm, _ = V.vitpose(w, probe.to(device), cfg, train=True)
        head_scale = 1.0 / float(hm.abs().max())
    w["vit.final_layer.weight"] = w["vit.final_layer.weight"] * head_scale
    return w, head_scale
