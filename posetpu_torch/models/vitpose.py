"""ViTPose as a backbone of the multi-view model: a plain ViT encoder over
16x16 patches and SimpleBaseline's deconvolution head with two stages (Xu
et al., "ViTPose: Simple Vision Transformer Baselines for Human Pose
Estimation", NeurIPS 2022; ``mmpose/models/backbones/vit.py`` and
``TopdownHeatmapSimpleHead`` of github.com/ViTAE-Transformer/ViTPose).

The layer equations, for N images of H x W:

- patch embedding: ``Conv2d(3, C, 16, stride 16, padding 2)`` (a 16x16
  grid at 256x256), then ``x + pos[:, 1:] + pos[:, :1]``, ``pos`` a learned
  [1, 1 + tokens, C] whose first slot is added to every token;
- ``depth`` pre-norm blocks: ``x = x + DP_i(Attn(LN1(x)))``, ``x = x +
  DP_i(MLP(LN2(x)))``; LayerNorm eps 1e-6; ``Attn`` one ``Linear(C, 3C)``
  with bias over ``heads`` heads, ``softmax(q k^T / sqrt(C / heads)) v``,
  ``Linear(C, C)``; ``MLP`` ``Linear(C, 4C)``, exact (erf) GELU,
  ``Linear(4C, C)``; ``DP_i`` stochastic depth at ``linspace(0,
  drop_path_rate, depth)[i]``, one draw an image keeping or zeroing the
  branch, a kept branch scaled by ``1 / (1 - rate)``;
- the last LayerNorm, the tokens back to a [N, C, h, w] map, and
  :func:`~posetpu_torch.models.pose_resnet.deconv_head`.

Precision as PoseResNet's ``dtype``: parameters f32, each matmul's and
convolution's operands cast to ``dtype`` at use, LayerNorm in f32 and the
residual stream f32 (both f64 under an f64 ``dtype``); attention is
``F.scaled_dot_product_attention``.

Drop path draws from a ``torch.Generator`` on the input's device, seeded
with ``drop_path_seed`` when the model first runs in training there: one
``torch.rand(N)`` a block, in block order, a training forward (block 0,
at rate 0, draws too, so the masks of block i are the i-th draw). An
evaluation forward draws nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from posetpu_torch.models.pose_resnet import add_deconv_head, deconv_head
from posetpu_torch.utils.profiling import span

LN_EPS = 1e-6


def _linear(m: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype))


def _wide(dtype):
    """The residual stream's and LayerNorm's dtype: f32, or f64 under an f64 ``dtype``."""
    return torch.promote_types(dtype, torch.float32)


def _ln(m: nn.LayerNorm, x):
    return F.layer_norm(x.to(_wide(x.dtype)), m.normalized_shape, m.weight, m.bias, m.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x, dtype):
        n, t, c = x.shape
        qkv = _linear(self.qkv, x, dtype).view(n, t, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [N, heads, T, d] each
        o = F.scaled_dot_product_attention(q, k, v, scale=self.scale)
        return _linear(self.proj, o.transpose(1, 2).reshape(n, t, c), dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype)), dtype)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, dtype, keep=None):
        """``keep``: None, or the drop-path factor an image [N] (0 or
        1 / (1 - rate)) for both branches."""
        n, t, c = x.shape
        hidden = self.mlp.fc1.out_features
        with span("vit.attention", flops=2 * n * t * (4 * c * c + 2 * t * c)):
            a = self.attn(_ln(self.norm1, x), dtype)
            x = x + (a if keep is None else a * keep)
        with span("vit.mlp", flops=4 * n * t * c * hidden):
            m = self.mlp(_ln(self.norm2, x), dtype)
            x = x + (m if keep is None else m * keep)
        return x


class ViTPose(nn.Module):
    """ViT encoder + deconv head. ``forward(x [N, H, W, 3])`` returns
    (heatmaps [N, h, w, J] f32, the patch embedding [N, H/16, W/16, C],
    the last deconvolution's features [N, h, w, F]), NHWC, the features in
    ``dtype``: PoseResNet's contract."""

    def __init__(self, image_size=(256, 256), patch_size: int = 16, patch_padding: int = 2,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.55, num_joints: int = 16,
                 deconv_filters=(256, 256), deconv_kernels=(4, 4), final_conv_kernel: int = 1,
                 drop_path_seed: int = 0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.deconv_filters = tuple(deconv_filters)
        w, h = (int(s) for s in image_size)
        self.grid = tuple((s + 2 * patch_padding - patch_size) // patch_size + 1 for s in (h, w))
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size, patch_padding)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + self.grid[0] * self.grid[1], embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.drop_path_rates = torch.linspace(0, drop_path_rate, depth, device="cpu").tolist()
        add_deconv_head(self, embed_dim, self.deconv_filters, tuple(deconv_kernels), num_joints,
                        final_conv_kernel)
        self.drop_path_seed = int(drop_path_seed)
        self._gen = None
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None):
        """The published init: every Linear weight and ``pos_embed``
        trunc-normal(0.02) (cut at +-2), biases 0, LayerNorm 1 / 0, the patch
        embedding PyTorch's Conv2d default; the head as SimpleBaseline's
        (deconvolutions and the last convolution N(0, 0.001), biases 0,
        BatchNorm at identity)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)
        pe = self.patch_embed
        nn.init.kaiming_uniform_(pe.weight, a=math.sqrt(5), generator=generator)
        bound = 1.0 / math.sqrt(pe.weight[0].numel())
        nn.init.uniform_(pe.bias, -bound, bound, generator=generator)
        for m in [getattr(self, f"deconv{i}_conv") for i in range(len(self.deconv_filters))] + [
                self.final_layer]:
            nn.init.normal_(m.weight, std=0.001, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)

    def seed_drop_path(self, seed: int) -> None:
        """Draw the drop-path masks afresh from ``seed``."""
        self.drop_path_seed, self._gen = int(seed), None

    def _keep(self, n: int, device):
        """Each block's drop-path factors [N] of one training forward."""
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device).manual_seed(self.drop_path_seed)
        out = []
        for rate in self.drop_path_rates:
            u = torch.rand(n, generator=self._gen, device=device)
            out.append(((u >= rate).float() / (1.0 - rate)).view(n, 1, 1))
        return out

    def forward(self, x):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        with span("vit.patch_embed"):
            pe = self.patch_embed
            low = F.conv2d(x.to(dt), pe.weight.to(dt), pe.bias.to(dt), pe.stride, pe.padding)
            n, c, gh, gw = low.shape
            pos = self.pos_embed
            t = low.flatten(2).transpose(1, 2).to(_wide(dt)) + (pos[:, 1:] + pos[:, :1])
        keep = self._keep(n, t.device) if self.training else [None] * self.depth
        for blk, k in zip(self.blocks, keep):
            with span("vit.block"):
                t = blk(t, dt, k)
        with span("vit.norm"):
            f = _ln(self.last_norm, t).to(dt).transpose(1, 2).reshape(n, c, gh, gw)
        heatmaps, high = deconv_head(self, f, len(self.deconv_filters), dt)
        nhwc = lambda a: a.permute(0, 2, 3, 1)
        return nhwc(heatmaps).float(), nhwc(low), nhwc(high)


def layer_id(name: str, depth: int) -> int:
    """The layer of a parameter for layer-wise lr decay, ViTPose's
    ``get_num_layer_for_vit``: 0 for the patch embedding and ``pos_embed``,
    ``i + 1`` for block i, ``depth + 1`` for everything else (the last
    norm, the head, the fusion bank). ``name`` as the multi-view model
    names it (``vit.blocks.3.mlp.fc1.weight``) or as ViTPose does."""
    parts = name.split(".")
    if parts[0] == "vit":
        parts = parts[1:]
    if parts[0] in ("patch_embed", "pos_embed"):
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return depth + 1


def get_pose_net(cfg, dtype=torch.float32) -> ViTPose:
    """ViTPose of ``cfg.POSE_VIT`` at ``cfg.NETWORK``'s image size and
    joints, drop path seeded with ``cfg.SEED``."""
    v = cfg.POSE_VIT
    return ViTPose(image_size=tuple(int(s) for s in cfg.NETWORK.IMAGE_SIZE),
                   patch_size=int(v.PATCH_SIZE), patch_padding=int(v.PATCH_PADDING),
                   embed_dim=int(v.EMBED_DIM), depth=int(v.DEPTH), num_heads=int(v.NUM_HEADS),
                   mlp_ratio=float(v.MLP_RATIO), drop_path_rate=float(v.DROP_PATH_RATE),
                   num_joints=int(cfg.NETWORK.NUM_JOINTS),
                   deconv_filters=tuple(v.NUM_DECONV_FILTERS),
                   deconv_kernels=tuple(v.NUM_DECONV_KERNELS),
                   final_conv_kernel=int(v.FINAL_CONV_KERNEL), drop_path_seed=int(cfg.SEED),
                   dtype=dtype)
