"""Seeded weights with trained-like statistics, made on the device in a few
large calls, by the names of :func:`portbench.reference.model.param_spec`.

The recipe is ``chip_smoke.py:trained_like_`` (lines 372-395), frozen
here: He-scaled convolution and deconvolution kernels (fan-in the kernel's
input channels times its taps, four taps an output pixel for a
deconvolution), BatchNorm scales 1 + 0.1 N(0, 1), shifts and running means
0.1 N(0, 1), running variances 1 + 0.05 |N(0, 1)|, and the fusion bank at
its U(0, 0.1) init (``lib/models/multiview_pose_resnet.py``). Then the
path-1 head rescale of ``chip_smoke.py:main`` (lines 2601-2603): the head's
kernel is divided by the largest |heatmap| of a probe through the plain
reference, with BatchNorm as the cell runs it (its running statistics to
serve, the batch's to train), so the heatmaps span [-1, 1], the range a
trained head gives and the int8 fusion's input scale (1.2 / 127) assumes.

One departure: the head's kernel is He-scaled like the others, with a zero
bias, where ``trained_like_`` keeps the reference's N(0, 0.001) init and
gives the bias 0.1 N(0, 1). Under that init the bias set each map's level
and the trunk moved the maps by a small part of it, so the served joints
and the losses hardly depended on the trunk: a lower precision of the
whole model read as close to the reference as the program did (PERF.md).
``chip_smoke.py`` rescales in evaluation only; a training cell's
heatmaps come from batch statistics, so its probe runs with them.
"""

from __future__ import annotations

import torch

from portbench.reference import model as M


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a run's draws."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % 2**63)


def make(cfg: dict, seed: int, device, probe=None, head_scale: float | None = None,
         train: bool = False):
    """(weights {name: f32 tensor on ``device``}, head scale). ``probe``:
    normalised images [N, H, W, 3] for the head rescale, run with
    BatchNorm as the cell runs it (``train``: the probe's own batch
    statistics; else the running ones), unless ``head_scale`` (the factor
    an earlier call returned) is given."""
    spec = M.param_spec(cfg)
    gen = generator(seed, 0, device)
    normal = [(n, s, r) for n, s, r in spec if r != "bank"]
    sizes = [torch.Size(s).numel() for _, s, _ in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    w = {}
    for (name, shape, role), r in zip(normal, flat.split(sizes)):
        r = r.view(shape)
        if role in ("conv", "head.weight"):
            w[name] = r * (2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
        elif role == "deconv":
            w[name] = r * (2.0 / (shape[0] * 4)) ** 0.5
        elif role == "bn.weight":
            w[name] = 1.0 + 0.1 * r
        elif role == "bn.var":
            w[name] = 1.0 + 0.05 * r.abs()
        elif role == "head.bias":
            w[name] = torch.zeros(shape, device=device)
        else:  # BatchNorm shifts and running means
            w[name] = 0.1 * r
    del flat
    for name, shape, role in spec:
        if role == "bank":
            w[name] = torch.empty(shape, device=device).uniform_(0.0, 0.1, generator=gen)
    if head_scale is None:
        with M.full_f32(), torch.no_grad():
            hm, _ = M.pose_resnet(w, probe.to(device), cfg, train=train)
        head_scale = 1.0 / float(hm.abs().max())
    w["resnet.final_layer.weight"] = w["resnet.final_layer.weight"] * head_scale
    return w, head_scale
