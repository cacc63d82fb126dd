"""The plain reference of the multi-view pose ResNet, in plain PyTorch.

SimpleBaseline's PoseResNet (a ResNet trunk, three stride-2 4x4
deconvolutions with BatchNorm and ReLU, a 1x1 head; Xiao et al. 2018) run
over the four views of a group, and the cross-view fusion of Qiu et al.
2019 (``lib/models/multiview_pose_resnet.py``): twelve ChannelWiseFC maps of
S = h*w inputs to S outputs, one per ordered view pair, each target view's
fused map the mean of its three warped source maps.

Functional and written from the published description: the weights are a
dict of tensors by the names below, ``forward`` takes NHWC images and gives
channels-last heatmaps [N, V, h, w, J]. It imports nothing of the program.
BatchNorm in training normalises by the batch's biased moments and moves
the running averages by ``0.9 * ra + 0.1 * batch``: the published
PoseResNet's ``BN_MOMENTUM = 0.1`` (Xiao et al. 2018,
``lib/models/pose_resnet.py``), in PyTorch's convention, where the running
average takes 0.1 of the batch. The variance averaged is the biased one,
as Flax's ``nn.BatchNorm`` takes it in the JAX system this benchmark's
program ports; PyTorch's unbiased one differs by n / (n - 1), under 1.3e-4
at these sizes. In evaluation BatchNorm uses the running averages.

``cast``: None, or a function applied wherever a lower-precision run
stores a tensor: every operand and output of a convolution, a
deconvolution and the fusion's products, every BatchNorm's output and
every residual sum (the control's lower precision, see :func:`fp8_cast`).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-5
BN_KEEP = 0.9  # 1 - BN_MOMENTUM (0.1) of the published PoseResNet
# (block kind, blocks a stage) by depth: He et al. 2016, table 1
RESNET = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}
# the source view of each of the 12 ordered (target, slot) pairs: target 0
# reads views 1, 2, 3; target 1 reads 0, 2, 3; ...
SRC_VIEW = tuple(s for t in range(4) for s in range(4) if s != t)


def blocks(num_layers: int):
    """[(name, kind, in channels, planes, stride, has projection)] of the trunk."""
    kind, counts = RESNET[num_layers]
    expansion = 4 if kind == "bottleneck" else 1
    out, cin = [], 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), counts), start=1):
        for b in range(n):
            stride = (1 if stage == 1 else 2) if b == 0 else 1
            proj = b == 0 and (stride != 1 or cin != planes * expansion)
            out.append((f"layer{stage}_{b}", kind, cin, planes, stride, proj))
            cin = planes * expansion
    return out


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """[(name, shape, role)] of every parameter and BatchNorm statistic.
    Roles: ``conv`` (OIHW), ``deconv`` (IOHW), ``bn.weight``, ``bn.bias``,
    ``bn.mean``, ``bn.var``, ``head.weight``, ``head.bias``, ``bank``."""
    spec = []

    def conv(name, o, i, k):
        spec.append((f"resnet.{name}.weight", (o, i, k, k), "conv"))

    def bn(name, c):
        for leaf, role in (("weight", "bn.weight"), ("bias", "bn.bias"),
                           ("running_mean", "bn.mean"), ("running_var", "bn.var")):
            spec.append((f"resnet.{name}.{leaf}", (c,), role))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    for name, kind, cin, planes, stride, proj in blocks(cfg["num_layers"]):
        if kind == "bottleneck":
            conv(f"{name}.conv1", planes, cin, 1)
            bn(f"{name}.bn1", planes)
            conv(f"{name}.conv2", planes, planes, 3)
            bn(f"{name}.bn2", planes)
            conv(f"{name}.conv3", planes * 4, planes, 1)
            bn(f"{name}.bn3", planes * 4)
            cout = planes * 4
        else:
            conv(f"{name}.conv1", planes, cin, 3)
            bn(f"{name}.bn1", planes)
            conv(f"{name}.conv2", planes, planes, 3)
            bn(f"{name}.bn2", planes)
            cout = planes
        if proj:
            conv(f"{name}.downsample_conv", cout, cin, 1)
            bn(f"{name}.downsample_bn", cout)
    cin = blocks(cfg["num_layers"])[-1][3] * (4 if RESNET[cfg["num_layers"]][0] == "bottleneck"
                                             else 1)
    for i, (nf, k) in enumerate(zip(cfg["deconv_filters"], cfg["deconv_kernels"])):
        spec.append((f"resnet.deconv{i}_conv.weight", (cin, nf, k, k), "deconv"))
        bn(f"deconv{i}_bn", nf)
        cin = nf
    fk = cfg["final_conv_kernel"]
    spec.append(("resnet.final_layer.weight", (cfg["num_joints"], cin, fk, fk), "head.weight"))
    spec.append(("resnet.final_layer.bias", (cfg["num_joints"],), "head.bias"))
    if cfg["aggre"]:
        s = cfg["heatmap_size"][0] * cfg["heatmap_size"][1]
        spec.append(("aggre_layer.weight", (12, s, s), "bank"))
    return spec


@contextmanager
def full_f32():
    """f32 convolutions and matrix products in full f32 while the block
    runs (on this GPU they default to TF32, a lower precision), and cuDNN's
    deterministic algorithms, so one seed gives one reference."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = saved


def fp8_cast(t):
    """``t`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at e4m3's largest finite value, 448), back in ``t``'s dtype;
    the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = amax / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def int4_cast(t):
    """``t`` rounded to 4-bit integers in [-7, 7] with one scale a tensor
    (its largest magnitude at 7), back in ``t``'s dtype."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 7.0
    q = torch.clamp(torch.round(t.detach() / s), -7, 7) * s
    return t + (q - t).detach()


class _Net:
    """One forward: BatchNorm in training or evaluation, recording the
    batch moments in training."""

    def __init__(self, w, train: bool, cast):
        self.w, self.train, self.cast = w, train, cast or (lambda t: t)
        self.stats = {}

    def conv(self, x, name, stride=1):
        wt = self.w[f"resnet.{name}.weight"]
        k = wt.shape[-1]
        return self.cast(F.conv2d(self.cast(x), self.cast(wt), None, stride, (k - 1) // 2))

    def bn(self, x, name):
        p = f"resnet.{name}."
        if not self.train:
            return self.cast(F.batch_norm(x, self.w[p + "running_mean"],
                                          self.w[p + "running_var"], self.w[p + "weight"],
                                          self.w[p + "bias"], False, 0.0, BN_EPS))
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.stats[p + "running_mean"] = (BN_KEEP * self.w[p + "running_mean"]
                                              + (1 - BN_KEEP) * mean)
            self.stats[p + "running_var"] = (BN_KEEP * self.w[p + "running_var"]
                                             + (1 - BN_KEEP) * var)
        return self.cast(F.batch_norm(x, None, None, self.w[p + "weight"],
                                      self.w[p + "bias"], True, 0.0, BN_EPS))

    def block(self, x, name, kind, stride, proj):
        if kind == "bottleneck":
            out = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
            out = F.relu(self.bn(self.conv(out, f"{name}.conv2", stride), f"{name}.bn2"))
            out = self.bn(self.conv(out, f"{name}.conv3"), f"{name}.bn3")
        else:
            out = F.relu(self.bn(self.conv(x, f"{name}.conv1", stride), f"{name}.bn1"))
            out = self.bn(self.conv(out, f"{name}.conv2"), f"{name}.bn2")
        res = x
        if proj:
            res = self.bn(self.conv(x, f"{name}.downsample_conv", stride),
                          f"{name}.downsample_bn")
        return F.relu(self.cast(out + res))


def pose_resnet(w, x, cfg: dict, *, train: bool, cast=None, checkpoint: bool = False):
    """PoseResNet on NHWC images [N, H, W, 3] -> (heatmaps [N, h, w, J],
    new running averages {name: tensor}, empty in evaluation).
    ``checkpoint``: keep only each block's input for the backward pass and
    compute the block again there (same values, less memory)."""
    net = _Net(w, train, cast)
    h = x.permute(0, 3, 1, 2)
    h = F.relu(net.bn(net.conv(h, "conv1", 2), "bn1"))
    h = F.max_pool2d(h, 3, 2, 1)
    for name, kind, _, _, stride, proj in blocks(cfg["num_layers"]):
        if checkpoint and train:
            h = torch.utils.checkpoint.checkpoint(net.block, h, name, kind, stride, proj,
                                                  use_reentrant=False)
        else:
            h = net.block(h, name, kind, stride, proj)
    for i, k in enumerate(cfg["deconv_kernels"]):
        pad, out_pad = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]
        wt = w[f"resnet.deconv{i}_conv.weight"]
        h = net.cast(F.conv_transpose2d(net.cast(h), net.cast(wt), None, 2, pad, out_pad))
        h = F.relu(net.bn(h, f"deconv{i}_bn"))
    wt, b = w["resnet.final_layer.weight"], w["resnet.final_layer.bias"]
    h = net.cast(F.conv2d(net.cast(h), net.cast(wt), b, 1, (wt.shape[-1] - 1) // 2))
    return h.permute(0, 2, 3, 1), net.stats


def fuse(heatmaps, bank, cast=None):
    """The twelve ChannelWiseFC warps: heatmaps [N, 4, h, w, J], bank
    [12, S, S] -> fused [N, 4, h, w, J], each target view the mean of its
    three sources' warps (x [.., S] @ W [S, S])."""
    cast = cast or (lambda t: t)
    n, v, h, w, j = heatmaps.shape
    x = heatmaps.reshape(n, v, h * w, j).transpose(2, 3)  # [N, V, J, S]
    out = []
    for t in range(4):
        acc = 0.0
        for slot in range(3):
            k = 3 * t + slot
            acc = acc + cast(cast(x[:, SRC_VIEW[k]]) @ cast(bank[k]))
        out.append(cast(acc / 3.0))
    fused = torch.stack(out, dim=1)  # [N, V, J, S]
    return fused.transpose(2, 3).reshape(n, v, h, w, j)


def forward(w, views, cfg: dict, *, train: bool, cast=None, checkpoint: bool = False):
    """views [N, V, H, W, 3] normalised -> (raw [N, V, h, w, J], fused or
    None, new running averages)."""
    n, v = views.shape[:2]
    hm, stats = pose_resnet(w, views.reshape((n * v,) + views.shape[2:]), cfg,
                            train=train, cast=cast, checkpoint=checkpoint)
    raw = hm.reshape((n, v) + hm.shape[1:])
    fused = fuse(raw, w["aggre_layer.weight"], cast) if cfg["aggre"] else None
    return raw, fused, stats


def route(raw, fused, is_h36m):
    """Inference-time fuse routing of the reference (lib/core/function.py):
    3/5 fused + 2/5 raw on H36M groups, the raw maps elsewhere."""
    if fused is None:
        return raw
    m = is_h36m.to(raw.dtype).reshape(-1, 1, 1, 1, 1)
    return (0.6 * fused + 0.4 * raw) * m + raw * (1.0 - m)
