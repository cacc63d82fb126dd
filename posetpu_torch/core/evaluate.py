"""Train-time PCK accuracy from heatmaps (lib/core/evaluate.py:17-72),
batched."""

from __future__ import annotations

import torch

from posetpu_torch.ops.heatmap import max_preds


def pck_accuracy(output, target, thr: float = 0.5):
    """PCK between the argmax decodes of predicted and GT heatmaps
    [N, J, h, w]. Returns (per_joint_acc [J], -1 where a joint has no valid
    GT; avg_acc; valid_joint_count; preds [N, J, 2]).

    As the reference: a GT joint is valid when both decoded coords are
    > 1, distances are normalised per axis by (h / 10, w / 10), and the
    average runs over the joints with a valid sample."""
    pred, _ = max_preds(output)
    gt, _ = max_preds(target)
    h, w = output.shape[-2:]
    norm = torch.tensor([h / 10.0, w / 10.0], dtype=torch.float32, device=pred.device)
    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)  # [N, J]
    d = torch.linalg.vector_norm((pred - gt) / norm, dim=-1)
    hits = (d < thr) & valid
    n_valid = valid.sum(0)
    per_joint = torch.where(n_valid > 0, hits.sum(0) / torch.clamp(n_valid, min=1),
                            torch.full_like(d[0], -1.0))
    usable = per_joint >= 0
    cnt = usable.sum()
    avg = torch.where(usable, per_joint, 0.0).sum() / torch.clamp(cnt, min=1)
    return per_joint, avg, cnt, pred
