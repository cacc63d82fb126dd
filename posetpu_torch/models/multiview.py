"""Multi-view wrapper + cross-view heatmap aggregation.

The reference runs 12 separate ``ChannelWiseFC`` modules in a Python double
loop over ordered view pairs (lib/models/multiview_pose_resnet.py:42-58).
Here the bank is ONE ``[12, S, S]`` parameter and the fusion one batched
matmul with the per-view mean folded in. Views live in a leading axis and
are folded into the batch for the shared backbone. ``dtype`` is Flax's (see
models/pose_resnet.py): the bank stays f32 and the product runs in ``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from posetpu_torch.models.pose_resnet import PoseResNet, get_pose_net

# source-view index for each of the 12 ordered (target i, slot) pairs, in the
# reference's fc_idx order: i=0 reads views 1,2,3; i=1 reads 0,2,3; ...
SRC_VIEW = tuple(src for tgt in range(4) for src in range(4) if src != tgt)


class Aggregation(nn.Module):
    """12-way learned heatmap warp bank (multiview_pose_resnet.py:31-58)."""

    def __init__(self, heatmap_size: int,
                 generator: torch.Generator | None = None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        s = heatmap_size * heatmap_size
        # ChannelWiseFC init U(0, 0.1)
        self.weight = nn.Parameter(torch.empty(12, s, s))
        nn.init.uniform_(self.weight, 0.0, 0.1, generator=generator)

    def forward(self, heatmaps):
        """heatmaps: [N, 4, h, w, J] -> fused [N, 4, h, w, J] f32. Each
        target view's output is the mean of its three warped source views;
        the gathered maps and the bank are cast to ``dtype`` for the
        product."""
        return aggregate(heatmaps, self.weight, self.dtype)


def aggregate(heatmaps, bank, dtype=torch.float32):
    """:class:`Aggregation`'s forward with the bank [12, S, S] given:
    heatmaps [N, 4, h, w, J] -> fused [N, 4, h, w, J] f32, the product in
    ``dtype``."""
    n, v, h, w, j = heatmaps.shape
    if v != 4:
        raise ValueError(f"the aggregation bank is built for 4 views, got {v}")
    s = h * w
    x = heatmaps.reshape(n, v, s, j).transpose(2, 3)  # [N, V, J, S]
    g = x[:, list(SRC_VIEW)].transpose(0, 1).reshape(12, n * j, s)
    warped = torch.bmm(g.to(dtype), bank.to(dtype))  # [12, N*J, S]
    fused = warped.reshape(4, 3, n, j, s).mean(dim=1)  # [V, N, J, S]
    return fused.permute(1, 0, 3, 2).reshape(n, v, h, w, j).float()


class MultiViewPose(nn.Module):
    """Shared backbone over 4 views + optional aggregation
    (multiview_pose_resnet.py:61-84). The backbone is a PoseResNet, held
    as ``resnet`` (the name the int8 path, serving and the weight bridges
    read), or a ViTPose, held as ``vit``; :attr:`backbone` is either."""

    def __init__(self, backbone: nn.Module, heatmap_size: int | None = None,
                 generator: torch.Generator | None = None, dtype=torch.float32):
        super().__init__()
        self.backbone_name = "resnet" if isinstance(backbone, PoseResNet) else "vit"
        self.add_module(self.backbone_name, backbone)
        self.aggre_layer = (None if heatmap_size is None
                            else Aggregation(heatmap_size, generator, dtype))

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.backbone_name)

    def forward(self, views):
        """views: [N, V, H, W, 3] -> (raw [N, V, h, w, J], fused or None,
        low_features, high_features)."""
        n, v = views.shape[:2]
        heatmaps, low, high = self.backbone(views.reshape((n * v,) + views.shape[2:]))
        split = lambda t: t.reshape((n, v) + t.shape[1:])
        heatmaps, low, high = split(heatmaps), split(low), split(high)
        fused = None if self.aggre_layer is None else self.aggre_layer(heatmaps)
        return heatmaps, fused, low, high


BACKBONES = ("pose_resnet", "vitpose")


def get_multiview_pose_net(cfg, generator: torch.Generator | None = None,
                           dtype=torch.float32) -> MultiViewPose:
    """The backbone ``cfg.BACKBONE_MODEL`` names (``pose_resnet`` from
    ``cfg.POSE_RESNET``, ``vitpose`` from ``cfg.POSE_VIT``) over the views,
    and the bank where ``NETWORK.AGGRE``. ``dtype`` for the backbone and
    the bank's product; parameters f32."""
    if cfg.BACKBONE_MODEL == "pose_resnet":
        backbone = get_pose_net(cfg, dtype)
    elif cfg.BACKBONE_MODEL == "vitpose":
        from posetpu_torch.models.vitpose import get_pose_net as get_vitpose

        backbone = get_vitpose(cfg, dtype)
    else:
        raise ValueError(f"unknown BACKBONE_MODEL {cfg.BACKBONE_MODEL!r}: one of {BACKBONES}")
    if generator is not None:
        backbone.init_weights(generator)
    size = int(cfg.NETWORK.HEATMAP_SIZE[0]) if bool(cfg.NETWORK.AGGRE) else None
    return MultiViewPose(backbone, size, generator, dtype)


def require_pose_resnet(model, where: str) -> None:
    """ValueError unless ``model`` (a MultiViewPose, or a backbone) runs a
    PoseResNet: the paths built for its layers say so before they start."""
    backbone = model.backbone if isinstance(model, MultiViewPose) else model
    if not isinstance(backbone, PoseResNet):
        raise ValueError(f"{where} is built for PoseResNet (BACKBONE_MODEL pose_resnet), "
                         f"not {type(backbone).__name__}")
