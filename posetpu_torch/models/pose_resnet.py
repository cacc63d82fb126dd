"""SimpleBaseline PoseResNet as a PyTorch module — ResNet backbone + deconv
heatmap head (reference: lib/models/pose_resnet.py:102-254).

Layout is NCHW inside the module (PyTorch's own), NHWC at ``forward``'s
boundary so callers pass the same [N, H, W, 3] images as to the JAX model.
The deconvs are native ``nn.ConvTranspose2d`` (k4/s2/p1), so weights carry
the reference checkpoint layout unchanged. Submodule names follow the JAX
model (``layer1_0.conv1``, ``deconv0_conv``, ``final_layer``) so the weight
bridge (models/convert.py) is a pure name-and-layout mapping.

``dtype`` is Flax's ``dtype`` with ``param_dtype=float32``: parameters stay
f32 and each conv, deconv and BatchNorm computes in ``dtype`` (explicit
casts of the weights at use, not autocast, whose op lists differ from
Flax's); the heatmaps leave in f32. BatchNorm keeps Flax's training
semantics (:class:`BatchNorm`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from posetpu_torch.parallel.batchnorm import batch_stats_mesh, global_batch_norm
from posetpu_torch.utils.profiling import span

BN_MOMENTUM = 0.1  # torch's convention; Flax's 0.9 = 1 - 0.1

# (block kind, per-stage block counts) per depth — the standard ResNet family
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's semantics (flax.linen.BatchNorm, momentum 0.9):
    in training the running averages move by ``0.9 * ra + 0.1 * batch`` with
    the *biased* batch variance (``nn.BatchNorm2d`` uses the unbiased one),
    reduced in f32 whatever the input's dtype; the input is normalised by
    the batch statistics. The output keeps the input's dtype; the scale,
    shift and statistics stay f32.

    Under parallel/batchnorm.sync_batch_stats (a train step over several
    processes) the moments are the global batch's, Flax's ``mean(x)`` and
    ``mean(x^2) - mean(x)^2`` from sums all-reduced over the ranks; the
    input is normalised by them and the running averages move by them."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mesh = batch_stats_mesh()
        if mesh is not None:
            return self._global(x, mesh)
        # momentum 1 leaves the batch's mean and unbiased variance in the
        # temporaries, from the same pass that normalises x
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = 1.0 - BN_MOMENTUM
            self.running_mean.mul_(m).add_(mean * BN_MOMENTUM)
            self.running_var.mul_(m).add_(var * ((n - 1) / n) * BN_MOMENTUM)
        return y

    def _global(self, x, mesh):
        y, mean, var = global_batch_norm(x, self.weight, self.bias, self.eps, mesh)
        with torch.no_grad():
            m = 1.0 - BN_MOMENTUM
            self.running_mean.mul_(m).add_(mean.to(self.running_mean.dtype) * BN_MOMENTUM)
            self.running_var.mul_(m).add_(var.to(self.running_var.dtype) * BN_MOMENTUM)
        return y


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


def _bn(c):
    return BatchNorm(c, eps=1e-5, momentum=BN_MOMENTUM)


def conv(m, x, dtype):
    """``m`` (an ``nn.Conv2d`` or ``nn.ConvTranspose2d``) applied to ``x`` in
    ``dtype``, its f32 weights cast at use."""
    w = m.weight.to(dtype)
    b = None if m.bias is None else m.bias.to(dtype)
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, m.stride, m.padding, m.output_padding)
    return F.conv2d(x, w, b, m.stride, m.padding)


def add_deconv_head(m: nn.Module, inplanes: int, filters, kernels, num_joints: int,
                    final_conv_kernel: int = 1, deconv_with_bias: bool = False) -> None:
    """SimpleBaseline's heatmap head as submodules of ``m``: for each filter
    count a stride-2 ``deconv{i}_conv`` (``nn.ConvTranspose2d``) and its
    ``deconv{i}_bn``, then ``final_layer``, a convolution with bias to the
    joints. The names are the ones the weight bridge and the int8 path
    read; PoseResNet's three deconvolutions and ViTPose's two
    (TopdownHeatmapSimpleHead) are both this head."""
    for i, (nf, nk) in enumerate(zip(filters, kernels)):
        padding, out_padding = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[nk]
        m.add_module(f"deconv{i}_conv", nn.ConvTranspose2d(
            inplanes, nf, nk, 2, padding, out_padding, bias=deconv_with_bias))
        m.add_module(f"deconv{i}_bn", _bn(nf))
        inplanes = nf
    pad = 1 if final_conv_kernel == 3 else 0
    m.final_layer = nn.Conv2d(inplanes, num_joints, final_conv_kernel, 1, pad, bias=True)


def deconv_head(m: nn.Module, x, num_deconvs: int, dtype):
    """The head :func:`add_deconv_head` put on ``m``, over NCHW features
    ``x`` in ``dtype``: (heatmaps NCHW in ``dtype``, the last deconvolution's
    features after BatchNorm and ReLU)."""
    with span("head.deconv"):
        for i in range(num_deconvs):
            x = conv(getattr(m, f"deconv{i}_conv"), x, dtype)
            x = F.relu(getattr(m, f"deconv{i}_bn")(x))
        return conv(m.final_layer, x, dtype), x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample_conv = _conv(inplanes, planes, 1, stride) if downsample else None
        self.downsample_bn = _bn(planes) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        out = self.bn2(conv(self.conv2, out, self.dtype))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(conv(self.downsample_conv, x, self.dtype))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample_conv = (_conv(inplanes, planes * 4, 1, stride)
                                if downsample else None)
        self.downsample_bn = _bn(planes * 4) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        out = F.relu(self.bn2(conv(self.conv2, out, self.dtype)))
        out = self.bn3(conv(self.conv3, out, self.dtype))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(conv(self.downsample_conv, x, self.dtype))
        return F.relu(out + residual)


class PoseResNet(nn.Module):
    """Backbone + deconv head. ``forward(x [N, H, W, 3])`` returns
    (heatmaps [N, h, w, J] f32, layer1 features, deconv features), NHWC,
    the features in ``dtype``."""

    def __init__(self, num_layers: int = 50, num_joints: int = 16,
                 deconv_filters=(256, 256, 256), deconv_kernels=(4, 4, 4),
                 final_conv_kernel: int = 1, deconv_with_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.num_joints = num_joints
        self.deconv_filters = tuple(deconv_filters)
        self.deconv_kernels = tuple(deconv_kernels)
        kind, stage_blocks = RESNET_SPEC[num_layers]
        block_cls = BasicBlock if kind == "basic" else Bottleneck

        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.block_names = []
        inplanes = 64
        for stage, (planes, nblocks) in enumerate(
                zip((64, 128, 256, 512), stage_blocks), start=1):
            for b in range(nblocks):
                stride = (1 if stage == 1 else 2) if b == 0 else 1
                need_ds = b == 0 and (stride != 1
                                      or inplanes != planes * block_cls.expansion)
                name = f"layer{stage}_{b}"
                self.add_module(name, block_cls(inplanes, planes, stride, need_ds, dtype))
                self.block_names.append(name)
                inplanes = planes * block_cls.expansion

        add_deconv_head(self, inplanes, self.deconv_filters, self.deconv_kernels, num_joints,
                        final_conv_kernel, deconv_with_bias)
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None):
        """The reference's init (pose_resnet.py:190-254): every conv and
        deconv kernel N(0, 0.001), conv biases 0, BN at identity."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.normal_(m.weight, std=0.001, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        x1 = None
        for name in self.block_names:
            x = getattr(self, name)(x)
            if name.startswith("layer1_"):
                x1 = x
        heatmaps, f = deconv_head(self, x, len(self.deconv_filters), self.dtype)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return nhwc(heatmaps).float(), nhwc(x1), nhwc(f)


def get_pose_net(cfg, dtype=torch.float32) -> PoseResNet:
    """Factory mirroring the reference entry point (pose_resnet.py:257-266)."""
    return PoseResNet(
        num_layers=cfg.POSE_RESNET.NUM_LAYERS,
        num_joints=cfg.NETWORK.NUM_JOINTS,
        deconv_filters=tuple(cfg.POSE_RESNET.NUM_DECONV_FILTERS),
        deconv_kernels=tuple(cfg.POSE_RESNET.NUM_DECONV_KERNELS),
        final_conv_kernel=cfg.POSE_RESNET.FINAL_CONV_KERNEL,
        deconv_with_bias=cfg.POSE_RESNET.DECONV_WITH_BIAS,
        dtype=dtype,
    )
