"""The deterministic training losses, batched over views (the reference's
lib/core/loss.py:25-133 and the consistency loss inline in
lib/core/function.py), each one reduction over a ``[N, V, ...]`` batch,
and the measures of the adversarial losses (loss.py:25-62, 400-474; the
BCE of the domain GAN).

Heatmaps are channels-last ``[..., h, w, J]`` as the model returns them;
weights ``[..., J]``.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

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


# ------------------------------------------------- the adversarial losses' measures

LOG2 = math.log(2.0)
MEASURES = ("GAN", "JSD", "X2", "KL", "RKL", "DV", "H2", "W1")


def bce_loss(scores, labels):
    """Binary cross-entropy on probabilities (torch.nn.BCELoss's semantics,
    used by the domain-transfer GAN, function.py:241), the probabilities
    clipped to [1e-7, 1 - 1e-7] first."""
    s = torch.clamp(scores, 1e-7, 1.0 - 1e-7)
    return -(labels * torch.log(s) + (1.0 - labels) * torch.log(1.0 - s)).mean()


def infonce_paired(embd1, embd2):
    """InfoNCE over two [N, C] embedding batches: the diagonal pairs are the
    positives, the off-diagonal ones the negatives (get_infonce_loss,
    loss.py:25-41). The negatives' diagonal is filled with -10."""
    n = embd1.shape[0]
    u_p = (embd1 * embd2).sum(dim=1, keepdim=True)  # [N, 1]
    eye = torch.eye(n, dtype=embd1.dtype, device=embd1.device)
    u_n = (embd1 @ embd2.T) * (1 - eye) - 10.0 * eye
    logits = torch.cat([u_p, u_n], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def jsd_paired(embd1, embd2):
    """Jensen-Shannon MI bound over two [N, C] embedding batches
    (get_jsd_loss, loss.py:43-62)."""
    u = embd1 @ embd2.T
    eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
    e_pos = LOG2 - F.softplus(-u)
    e_neg = F.softplus(-u) + u - LOG2
    return (e_neg * (1 - eye)).sum() / (1 - eye).sum() - (e_pos * eye).sum() / eye.sum()


def positive_expectation(p_samples, measure: str, average: bool = True):
    """The f-divergence's positive term (MILoss.get_positive_expectation,
    loss.py:400-436) for one of :data:`MEASURES`."""
    if measure == "GAN":
        ep = -F.softplus(-p_samples)
    elif measure == "JSD":
        ep = LOG2 - F.softplus(-p_samples)
    elif measure == "X2":
        ep = p_samples ** 2
    elif measure in ("KL", "DV", "W1"):
        ep = p_samples
    elif measure == "RKL":
        ep = -torch.exp(-p_samples)
    elif measure == "H2":
        ep = 1.0 - torch.exp(-p_samples)
    else:
        raise ValueError(f"unknown measure {measure}")
    return ep.mean() if average else ep


def negative_expectation(q_samples, measure: str, average: bool = True):
    """The f-divergence's negative term (loss.py:438-474); DV's log-mean-exp
    runs over the first axis."""
    if measure == "GAN":
        eq = F.softplus(-q_samples) + q_samples
    elif measure == "JSD":
        eq = F.softplus(-q_samples) + q_samples - LOG2
    elif measure == "X2":
        eq = -0.5 * (q_samples.abs() + 1.0) ** 2
    elif measure == "KL":
        eq = torch.exp(q_samples - 1.0)
    elif measure == "RKL":
        eq = q_samples - 1.0
    elif measure == "DV":
        eq = torch.logsumexp(q_samples, dim=0) - math.log(q_samples.shape[0])
    elif measure == "H2":
        eq = torch.exp(q_samples) - 1.0
    elif measure == "W1":
        eq = q_samples
    else:
        raise ValueError(f"unknown measure {measure}")
    return eq.mean() if average else eq


def fenchel_dual_loss(pos_scores, neg_scores, measure: str):
    """E_neg - E_pos for the measures other than NCE (MILoss.__call__)."""
    return negative_expectation(neg_scores, measure) - positive_expectation(pos_scores, measure)
