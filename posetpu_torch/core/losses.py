"""The deterministic training losses, batched over views (the reference's
lib/core/loss.py:25-133 and the consistency loss inline in
lib/core/function.py), each one reduction over a ``[N, V, ...]`` batch.

Heatmaps are channels-last ``[..., h, w, J]`` as the model returns them;
weights ``[..., J]``.
"""

from __future__ import annotations

import itertools

import torch

# the 12 ordered view pairs in itertools order: the reference's F-matrix keys
# (loss.py:123)
VIEW_PERMS = tuple(itertools.permutations(range(4), 2))


def joints_mse_loss(output, target, target_weight=None):
    """Weighted per-joint heatmap MSE (JointsMSELoss, loss.py:64-86): each
    joint contributes ``mean((w * (pred - gt))^2)`` over every leading axis
    and pixel (the weight multiplies the maps before the square, so it
    enters squared), and the joints are summed. output/target
    [..., h, w, J]; target_weight [..., J] or None."""
    diff = output - target
    if target_weight is not None:
        diff = diff * target_weight[..., None, None, :]
    return (diff * diff).mean(dim=tuple(range(diff.dim() - 1))).sum()


def consistency_loss(raw, fused, mask=None):
    """MSE between raw and aggregated heatmaps (function.py:291-296) over
    the samples ``mask`` [N] selects: the mean is over the selected
    elements only, as the reference concatenates the selected rows first."""
    se = (raw - fused) ** 2
    if mask is None:
        return se.mean()
    m = mask.reshape(mask.shape + (1,) * (se.dim() - mask.dim())).to(se.dtype)
    denom = torch.clamp(m.sum() * se[0].numel() / max(1, m[0].numel()), min=1.0)
    return (se * m).sum() / denom


def fundamental_loss(joints_2d, target_weight, fmats, sample_mask=None,
                     use_target_weight: bool = True):
    """Epipolar residual |x2^T F x1| over the 12 ordered view pairs
    (FundamentalLoss, loss.py:89-133). joints_2d [N, V, J, 2] image pixels;
    target_weight [N, V, J]; fmats [N, 12, 3, 3] in :data:`VIEW_PERMS`
    order; sample_mask [N] (0 for rows that have no F). The sum over
    (samples, pairs, joints) is divided by N * 12 * J with N the full batch.

    The bilinear form is taken in coordinates centred on the joints' mean
    (under no gradient), with F conjugated by the same translation: exact
    algebra, but with ~1000 px coordinates it keeps the f32 products ~10x
    smaller."""
    n, v, j, _ = joints_2d.shape
    c = joints_2d.detach().mean(dim=(0, 1, 2))
    homo = torch.cat([joints_2d - c, torch.ones_like(joints_2d[..., :1])], dim=-1)
    # F' = T^T F T, T = [[1, 0, cx], [0, 1, cy], [0, 0, 1]]
    col = fmats[..., :, 2] + (fmats[..., :, 0] * c[0] + fmats[..., :, 1] * c[1])
    fc = torch.cat([fmats[..., :, :2], col[..., None]], dim=-1)
    row = fc[..., 2, :] + (fc[..., 0, :] * c[0] + fc[..., 1, :] * c[1])
    fc = torch.cat([fc[..., :2, :], row[..., None, :]], dim=-2)
    a = [p[0] for p in VIEW_PERMS]
    b = [p[1] for p in VIEW_PERMS]
    dt = torch.promote_types(homo.dtype, fc.dtype)
    x1, x2, fc = homo[:, a].to(dt), homo[:, b].to(dt), fc.to(dt)  # x [N, 12, J, 3]
    # residual_j = x2_j^T F x1_j (reference: sum((h2 @ F) * h1, dim=1))
    res = ((x2 @ fc) * x1).sum(-1).abs()
    if use_target_weight:
        res = res * (target_weight[:, a] * target_weight[:, b])
    if sample_mask is not None:
        res = res * sample_mask[:, None, None]
    return res.sum() / (n * len(VIEW_PERMS) * j)
