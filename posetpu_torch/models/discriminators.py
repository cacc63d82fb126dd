"""The critics of the MI and domain-transfer losses (the reference's
lib/models/discriminator.py:28-242; its GlobalDiscriminator is an empty stub
there and has no counterpart).

Inputs are channels-last, as the JAX package's: position pairs ``[..., L,
C]``, embeddings ``[N, C]``, domain features ``[M, h, w, C]``. A 1x1
convolution over channels-last positions is an ``nn.Linear``. Submodule names
follow the Flax modules' (``low_net.conv1``, ``view1_net.fc1``, ``bn1``), so
models/convert.py carries Flax variables across by name.

Flax's conventions, kept: LayerNorm's eps is 1e-6, BatchNorm's 1e-5, the
leaky ReLU's slope 0.2; a critic computes in its parameters' dtype, its
inputs cast to it (Flax's ``dtype``). :class:`BatchNorm` in training normalises by the
batch's statistics and leaves the running ones as they are, as the JAX
adversarial step discards the discriminators' mutated statistics
(posetpu's train/gan.py:47-61, 415-417).

Weights: PyTorch's default init (the reference's: weights and biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in))) drawn from ``generator``, and the
shortcuts' "noisy identity" (discriminator.py:52-57, 83-89).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from posetpu_torch.models.pose_resnet import RESNET_SPEC

LEAKY_SLOPE = 0.2
LN_EPS = 1e-6  # flax.linen.LayerNorm's


class BatchNorm(nn.Module):
    """Flax's BatchNorm (eps 1e-5) over the channel axis of [M, C] or
    [N, C, H, W]. Training mode normalises by the batch's statistics and
    never updates ``running_mean`` / ``running_var``; eval mode normalises
    by them."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        stats = (None, None) if self.training else (self.running_mean, self.running_var)
        return F.batch_norm(x, *stats, self.weight, self.bias, self.training, 0.0, self.eps)


def _channels_last_bn(bn, x):
    """``bn`` over the last axis of x [..., C]: statistics over every other
    position."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def _uniform_(t, bound, generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def _noisy_identity_(weight, generator):
    """U(-0.01, 0.01) with ones on the leading diagonal: the reference's
    "noisy copy" shortcut (discriminator.py:52-57, 83-89). weight [O, I]."""
    _uniform_(weight, 0.01, generator)
    with torch.no_grad():
        weight.diagonal().fill_(1.0)


class _Critic(nn.Module):
    """Shared init: PyTorch's default for every Linear / Conv2d (the
    reference's), then each subclass's shortcuts."""

    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                _uniform_(m.weight, 1.0 / math.sqrt(fan_in), generator)
                if m.bias is not None:
                    _uniform_(m.bias, 1.0 / math.sqrt(fan_in), generator)
            elif isinstance(m, (BatchNorm, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if isinstance(m, (MI1x1ConvNet, MIFCNet)):
                _noisy_identity_(m.shortcut.weight, generator)
        return self


class MI1x1ConvNet(_Critic):
    """1x1-conv MI encoder with an identity-init shortcut and a channel
    LayerNorm (discriminator.py:28-64), on [..., C_in] -> [..., n_units]."""

    def __init__(self, in_channels: int, n_units: int):
        super().__init__()
        self.conv1 = nn.Linear(in_channels, n_units, bias=False)
        self.bn = BatchNorm(n_units)
        self.conv2 = nn.Linear(n_units, n_units)
        self.shortcut = nn.Linear(in_channels, n_units, bias=False)
        self.ln = nn.LayerNorm(n_units, eps=LN_EPS)

    def forward(self, x):
        x = x.to(self.conv1.weight.dtype)
        h = self.conv2(F.relu(_channels_last_bn(self.bn, self.conv1(x))))
        return self.ln(h + self.shortcut(x))


class MIFCNet(_Critic):
    """MLP MI encoder (discriminator.py:67-98): [N, C_in] -> [N, n_units]."""

    def __init__(self, in_channels: int, n_units: int, use_ln: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, n_units, bias=False)
        self.bn = BatchNorm(n_units)
        self.fc2 = nn.Linear(n_units, n_units)
        self.shortcut = nn.Linear(in_channels, n_units)
        self.ln = nn.LayerNorm(n_units, eps=LN_EPS) if use_ln else None

    def forward(self, x):
        x = x.to(self.fc1.weight.dtype)
        h = self.fc2(F.leaky_relu(self.bn(self.fc1(x)), LEAKY_SLOPE))
        out = h + self.shortcut(x)
        return out if self.ln is None else self.ln(out)


class LocalDiscriminator(_Critic):
    """Dot-product critic of two MI1x1ConvNet embeddings
    (discriminator.py:110-153): low [..., L, C_low], high [..., L, C_high]
    -> scores [..., L]. Its BN statistics run over all L positions (and any
    leading axes), as the JAX module's over its 1-wide map."""

    def __init__(self, low_channels: int, high_channels: int, out_channels: int = 2048):
        super().__init__()
        self.low_net = MI1x1ConvNet(low_channels, out_channels)
        self.high_net = MI1x1ConvNet(high_channels, out_channels)

    def forward(self, low, high):
        return (self.low_net(low) * self.high_net(high)).sum(-1)


class DomainDiscriminator(_Critic):
    """PatchGAN-style domain critic (discriminator.py:156-175) on [M, h, w,
    C] features: 1x1 conv to 256, 4x4 stride-2 conv (padding 1) to 128, 4x4
    VALID conv to 1, sigmoid; returns the patch map [M, h', w', 1] (29 x 29
    on 64 x 64 layer1 features)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 256, 1, bias=False)
        self.bn1 = BatchNorm(256)
        self.conv2 = nn.Conv2d(256, 128, 4, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm(128)
        self.conv3 = nn.Conv2d(128, 1, 4, bias=False)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        h = F.leaky_relu(self.bn1(self.conv1(h)), LEAKY_SLOPE)
        h = F.leaky_relu(self.bn2(self.conv2(h)), LEAKY_SLOPE)
        return torch.sigmoid(self.conv3(h)).permute(0, 2, 3, 1)


class _PairCritic(_Critic):
    """Two MIFCNet embeddings (with LayerNorm) of two flattened inputs,
    named by the subclass's ``names``."""

    names: tuple[str, str]

    def __init__(self, in1: int, in2: int, out_channels: int):
        super().__init__()
        for name, cin in zip(self.names, (in1, in2)):
            self.add_module(name, MIFCNet(cin, out_channels, use_ln=True))

    def forward(self, x1, x2):
        n = x1.shape[0]
        return tuple(getattr(self, name)(x.reshape(n, -1))
                     for name, x in zip(self.names, (x1, x2)))


class ViewDiscriminator(_PairCritic):
    """The view subsets' 2D joints, embedded (discriminator.py:178-199)."""

    names = ("view1_net", "view2_net")


class JointsDiscriminator(_PairCritic):
    """The joint subsets' coordinates, embedded (discriminator.py:202-222)."""

    names = ("var1_net", "var2_net")


class HeatmapDiscriminator(_Critic):
    """MLP scoring (heatmap probability, image feature) pairs
    (discriminator.py:225-242): [..., c_in] -> c_m -> c_m // 4 -> [..., 1]."""

    def __init__(self, in_channels: int, inter_channels: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, inter_channels, bias=False)
        self.bn1 = BatchNorm(inter_channels)
        self.fc2 = nn.Linear(inter_channels, inter_channels // 4)
        self.bn2 = BatchNorm(inter_channels // 4)
        self.fc3 = nn.Linear(inter_channels // 4, 1)

    def forward(self, pairs):
        pairs = pairs.to(self.fc1.weight.dtype)
        h = F.leaky_relu(_channels_last_bn(self.bn1, self.fc1(pairs)), LEAKY_SLOPE)
        h = F.leaky_relu(_channels_last_bn(self.bn2, self.fc2(h)), LEAKY_SLOPE)
        return self.fc3(h)


def _feature_channels(cfg) -> tuple[int, int]:
    """(layer1 channels, deconv channels) of ``cfg``'s PoseResNet: the low
    and high features the critics read (the JAX package reads them off a
    traced forward). Another backbone is refused (ValueError)."""
    if cfg.BACKBONE_MODEL != "pose_resnet":
        raise ValueError(f"the MI and domain critics are sized for PoseResNet's layer1 and "
                         f"deconv features, not BACKBONE_MODEL {cfg.BACKBONE_MODEL!r}")
    kind, _ = RESNET_SPEC[int(cfg.POSE_RESNET.NUM_LAYERS)]
    return 64 * (4 if kind == "bottleneck" else 1), int(cfg.POSE_RESNET.NUM_DECONV_FILTERS[-1])


def build_discriminators(cfg, generator: torch.Generator | None = None) -> dict:
    """The critics ``cfg.LOSS`` enables, keyed and ordered like the
    reference's model_dict (run/pose2d/train.py:163-180), their weights
    drawn from ``generator``, on the CPU."""
    flags = ("USE_LOCAL_MI_LOSS", "USE_DOMAIN_TRANSFER_LOSS", "USE_VIEW_MI_LOSS",
             "USE_JOINTS_MI_LOSS", "USE_HEATMAP_MI_LOSS")
    if not any(cfg.LOSS[f] for f in flags):
        return {}
    low, high = _feature_channels(cfg)
    joints = int(cfg.NETWORK.NUM_JOINTS)
    d = {}
    if cfg.LOSS.USE_LOCAL_MI_LOSS:
        d["local_discriminator"] = LocalDiscriminator(
            high, high, int(cfg.LOCAL_DISCRIMINATOR.OUTPUT_CHANNELS))
    if cfg.LOSS.USE_DOMAIN_TRANSFER_LOSS:
        d["domain_discriminator"] = DomainDiscriminator(low)
    if cfg.LOSS.USE_VIEW_MI_LOSS:
        v1 = int(cfg.VIEW_DISCRIMINATOR.VIEW_ONE_NUM)
        d["view_discriminator"] = ViewDiscriminator(
            v1 * joints * 2, (4 - v1) * joints * 2, int(cfg.VIEW_DISCRIMINATOR.OUTPUT_CHANNELS))
    if cfg.LOSS.USE_JOINTS_MI_LOSS:
        jd = cfg.JOINTS_DISCRIMINATOR
        d["joints_discriminator"] = JointsDiscriminator(
            int(jd.VAR_ONE_NUM) * 2, int(jd.VAR_TWO_NUM) * 2, int(jd.OUTPUT_CHANNELS))
    if cfg.LOSS.USE_HEATMAP_MI_LOSS:
        d["heatmap_discriminator"] = HeatmapDiscriminator(
            1 + low, int(cfg.HEATMAP_DISCRIMINATOR.INTER_CHANNELS))
    return {k: m.reset_parameters(generator) for k, m in d.items()}
