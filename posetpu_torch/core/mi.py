"""Mutual-information losses (Deep InfoMax style) and the domain GAN's
losses: the adversarial loss family of the reference's lib/core/loss.py:
136-780 and lib/core/function.py:233-257.

The random draws are split from the losses. Each draw depends only on the
configuration and the batch's ``joints_crop`` / ``joints_vis``, never on a
model output, so :func:`sample_draws` makes all the indices one adversarial
step needs from a ``torch.Generator`` and the losses take them as
arguments. The distributions are the JAX package's: with replacement over
the unmasked cells (:func:`categorical_rows`), without replacement by the
Gumbel top-k trick (:func:`gumbel_topk_rows`), uniform integers. A test can
feed the JAX package's draws to both packages.

Features are channels-last: ``[N, H, W, C]``. The critics (``d``) are the
modules of models/discriminators.py. The reference's variable-size index
sets (``nonzero()`` in the joint-specific variant) are dense masked pairs
with weighted reductions, as in the JAX package; its Global MI variant is a
stub there and has no counterpart.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from posetpu_torch.core.losses import LOG2, bce_loss, fenchel_dual_loss, infonce_paired, jsd_paired

# the 'org' / 'one_image' pair extraction supports 8x8 low and 64x64 high
# features only (loss.py:191-302): 36 3x3 patches of the low map
ORG_LOW, ORG_HIGH = 8, 64
ORG_PATCHES = (ORG_LOW - 2) ** 2


# ------------------------------------------------------------------ sampling


def categorical_rows(log_weights, n_samples: int, generator=None):
    """With replacement per row: log_weights [R, M] (0 where a cell may be
    drawn, -inf where not) -> indices [R, n_samples]."""
    return torch.multinomial(torch.softmax(log_weights, dim=-1), n_samples,
                             replacement=True, generator=generator)


def gumbel_topk_rows(log_weights, k: int, generator=None):
    """Without replacement per row by the Gumbel top-k trick: log_weights
    [R, M] -> indices [R, k]. A row that is all -inf yields some k of its
    cells (top-k over ties), as the JAX package's does."""
    u = torch.rand(log_weights.shape, generator=generator, dtype=log_weights.dtype,
                   device=log_weights.device)
    tiny = torch.finfo(log_weights.dtype).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.topk(log_weights + g, k, dim=-1).indices


def _feat_stride(cfg):
    return np.asarray(cfg.NETWORK.IMAGE_SIZE, np.float32) / np.asarray(
        cfg.NETWORK.HEATMAP_SIZE, np.float32)


def _gt_heatmap_cells(joints_crop, feat_stride, grid: int):
    """joints_2d_transformed -> integer heatmap cells (x, y), truncated and
    clamped (loss.py:213-214). joints_crop [..., J, 2] input-image coords."""
    stride = torch.as_tensor(feat_stride, dtype=torch.float32, device=joints_crop.device)
    cells = (joints_crop / stride + 0.5).to(torch.int64)
    return torch.clamp(cells, 0, grid - 1)


def _window(radius: int, width: int, device):
    """Flat offsets of a (2r+1)^2 window on rows of ``width`` cells: flat
    index arithmetic, so the window wraps across rows near an edge (the
    reference's and the JAX package's)."""
    offs = torch.arange(-radius, radius + 1, device=device)
    return (offs[:, None] * width + offs[None, :]).reshape(-1)


def local_joint_log_weights(joints_crop, feat_stride, hw: tuple[int, int], sigma: int):
    """The joint-specific variant's sampling masks (loss.py:304-390):
    (background [1, N*h*w]: every sample's GT cells excluded; negatives
    [N*J, N*h*w]: per joint the union over the batch of the 3 sigma windows
    around its GT cells excluded, rows n-major, j-minor)."""
    h, w = hw
    n, j = joints_crop.shape[:2]
    dev = joints_crop.device
    cells = _gt_heatmap_cells(joints_crop, feat_stride, h)
    gt_idx = cells[..., 1] * w + cells[..., 0]  # [N, J]
    base = (torch.arange(n, device=dev) * h * w)[:, None]
    bg = torch.zeros(1, n * h * w, device=dev)
    bg[0, (gt_idx + base).reshape(-1)] = -torch.inf
    masked = torch.clamp(gt_idx.reshape(-1)[:, None] + _window(sigma * 3, w, dev)[None, :],
                         0, h * w - 1).reshape(n, j, -1) + base[..., None]
    excl = masked.transpose(0, 1).reshape(j, -1)  # [J, N*(2r+1)^2]
    neg = torch.zeros(j, n * h * w, device=dev)
    neg.scatter_(1, excl, -torch.inf)
    return bg, neg.repeat(n, 1)


def sample_local_pairs(joints_crop, cfg, generator=None) -> dict:
    """One view's draws for :func:`local_mi_loss` (``cfg.LOSS.SPECIFIC``):
    'joint' -> {"bg": [2 T] background cells (global over the batch's
    maps), "neg": [N*J, Q] negative cells}; 'org' / 'one_image' ->
    {"cells": [N, K, 2] random positive cells (x, y), "neg": [N, Q*(K+J)]}
    (indices into the other images' patch pool, or raw indices that the
    loss shifts past the positive's patch). T / K is MI_POSITIVE_NUM, Q
    MI_NEG_POS_RATIO. joints_crop [N, J, 2] (the visibilities weight the
    pairs in the loss; the draws do not depend on them)."""
    specific = cfg.LOSS.SPECIFIC
    positive_num, neg_per_pos = int(cfg.LOSS.MI_POSITIVE_NUM), int(cfg.LOSS.MI_NEG_POS_RATIO)
    n, j = joints_crop.shape[:2]
    dev = joints_crop.device
    if specific == "joint":
        w, h = (int(s) for s in cfg.NETWORK.HEATMAP_SIZE)
        bg_logw, neg_logw = local_joint_log_weights(joints_crop, _feat_stride(cfg), (h, w),
                                                    int(cfg.NETWORK.SIGMA))
        return {"bg": categorical_rows(bg_logw, positive_num * 2, generator)[0],
                "neg": categorical_rows(neg_logw, neg_per_pos, generator)}
    if specific in ("org", "one_image"):
        nneg = neg_per_pos * (positive_num + j)
        pool = (n - 1) * ORG_PATCHES if specific == "org" else ORG_PATCHES - 1
        return {"cells": torch.randint(0, ORG_HIGH, (n, positive_num, 2), generator=generator,
                                       device=dev),
                "neg": torch.randint(0, pool, (n, nneg), generator=generator, device=dev)}
    raise ValueError(f"unknown LOSS.SPECIFIC {specific}")


def sample_heatmap_cells(joints_crop, joints_vis, cfg, joint_idx: int, generator=None):
    """One view's draw for :func:`heatmap_mi_loss`
    (HeatmapMILoss._sample_some_indices, loss.py:646-699): around the joint's
    GT cell (a uniform random cell where it is invisible) half the
    (2r+1)^2 window without replacement, r = 3 sigma + 2, then a quarter of
    the window's size of cells outside it, without replacement: [N, Q]
    flat cells, Q = w2 // 2 + w2 // 4. On a map smaller than the window,
    a row may have no cell outside it: top-k over all -inf, as in JAX."""
    w, h = (int(s) for s in cfg.NETWORK.HEATMAP_SIZE)
    n = joints_crop.shape[0]
    dev = joints_crop.device
    cells = _gt_heatmap_cells(joints_crop, _feat_stride(cfg), h)
    gt_idx = (cells[..., 1] * w + cells[..., 0])[:, joint_idx]
    rand_idx = torch.randint(0, h * w, (n,), generator=generator, device=dev)
    loc = torch.where(joints_vis[:, joint_idx] > 0, gt_idx, rand_idx)
    grid = _window(int(cfg.NETWORK.SIGMA) * 3 + 2, h, dev)
    w2 = grid.shape[0]
    masked = torch.clamp(loc[:, None] + grid[None, :], 0, h * h - 1)
    pick = gumbel_topk_rows(torch.zeros(masked.shape, device=dev), w2 // 2, generator)
    high_resp = torch.gather(masked, 1, pick)
    neg_logw = torch.zeros(n, h * h, device=dev).scatter_(1, masked, -torch.inf)
    low_resp = gumbel_topk_rows(neg_logw, w2 // 4, generator)
    return torch.cat([high_resp, low_resp], dim=1)


def sample_draws(batch, cfg, epoch_parity: int, generator=None) -> dict:
    """Every index one adversarial step (train/gan.py) draws, from
    ``generator`` on the batch's device: {"d": side, "g": side}, each side
    {"local": [one :func:`sample_local_pairs` per view], "heatmap": [one
    :func:`sample_heatmap_cells` per view]} with a key only where the step
    runs that loss on that side (the heatmap MI: D at parity 0, G at 1).
    The two sides draw apart, as the JAX step's two keys."""
    jc, jv = batch["joints_crop"], batch["joints_vis"]
    views = range(jc.shape[1])
    joint_idx = int(cfg.HEATMAP_DISCRIMINATOR.JOINT_IDX)
    draws = {}
    for side, heatmap_parity in (("d", 0), ("g", 1)):
        s = {}
        if cfg.LOSS.USE_LOCAL_MI_LOSS:
            s["local"] = [sample_local_pairs(jc[:, v], cfg, generator) for v in views]
        if cfg.LOSS.USE_HEATMAP_MI_LOSS and epoch_parity == heatmap_parity:
            s["heatmap"] = [sample_heatmap_cells(jc[:, v], jv[:, v], cfg, joint_idx, generator)
                            for v in views]
        draws[side] = s
    return draws


# ------------------------------------------------------ local MI (DIM-style)


def _unfold_3x3(x):
    """[N, H, W, C] -> [N, (H-2)*(W-2), 9*C] patches, ordered (kh, kw, C) as
    torch's unfold + permute in the reference (loss.py:206-209)."""
    n, h, w, c = x.shape
    taps = [x[:, dy:h - 2 + dy, dx:w - 2 + dx, :] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=3).reshape(n, (h - 2) * (w - 2), 9 * c)


def _take_rows(x, idx):
    """x [N, M, C] gathered along M by idx [N, K] -> [N, K, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def extract_local_pairs_org(low, high, joints_crop, feat_stride, positive_num: int,
                            neg_per_pos: int, draws: dict, cross_image: bool = True):
    """The 'org' (``cross_image``) and 'one_image' pair extraction
    (loss.py:191-302). low [N, 8, 8, C_low], high [N, 64, 64, C_high],
    joints_crop [N, J, 2]; draws from :func:`sample_local_pairs`. Returns
    (low_pos, high_pos, low_neg, high_neg) [N, L, C], L_pos = K + J, L_neg =
    Q * L_pos."""
    n, hl, _, _ = low.shape
    _, hh, wh, ch = high.shape
    if (hl, hh) != (ORG_LOW, ORG_HIGH):
        raise ValueError(f"the 'org' pairs need 8x8 low and 64x64 high features, "
                         f"got {hl} and {hh}")
    factor = hh // hl
    low_patches = _unfold_3x3(low)  # [N, 36, 9*C_low]
    side = hl - 2
    # positives: the random cells, then the GT joint cells
    cells = torch.cat([draws["cells"], _gt_heatmap_cells(joints_crop, feat_stride, hh)], dim=1)
    flat_high = cells[..., 1] * wh + cells[..., 0]
    cells_low = torch.clamp(torch.div(cells, factor, rounding_mode="floor") - 1, 0, side - 1)
    flat_low = cells_low[..., 1] * side + cells_low[..., 0]
    high_pos = _take_rows(high.reshape(n, hh * wh, ch), flat_high)
    low_pos = _take_rows(low_patches, flat_low)
    # negatives: each high anchor repeated, low patches from elsewhere
    high_neg = torch.repeat_interleave(high_pos, neg_per_pos, dim=1)
    if cross_image:  # the other images' patches (loss.py:228-235)
        other = torch.stack([torch.roll(torch.arange(n), -(s + 1)) for s in range(n - 1)], dim=1)
        pool = low_patches[other.reshape(-1).to(low.device)].reshape(
            n, (n - 1) * low_patches.shape[1], -1)
        low_neg = _take_rows(pool, draws["neg"])
    else:  # the same image's other patches (loss.py:285-292): shift past the positive's
        base = torch.repeat_interleave(flat_low, neg_per_pos, dim=1)
        raw = draws["neg"]
        low_neg = _take_rows(low_patches, raw + (raw >= base).to(raw.dtype))
    return low_pos, high_pos, low_neg, high_neg


def extract_local_pairs_joint(features, joints_crop, joints_vis, feat_stride,
                              positive_num: int, neg_per_pos: int, draws: dict):
    """The joint-specific variant (loss.py:330-390): features [N, h, w, C]
    (low == high); draws from :func:`sample_local_pairs`. Returns (low_pos
    [P, C], high_pos [P, C], pos_mask [P], low_neg [Nn, C], high_neg
    [Nn, C], neg_mask [Nn]).

    The reference's ``nonzero()`` pair list is dense masked pairs here, as
    in the JAX package: every ordered pair (a, b), a != b, of the batch's
    samples per joint, weighted by both visibilities, then the T background
    pairs; the negatives pair each GT anchor with Q cells outside every
    sample's window around that joint, weighted by its visibility."""
    n, h, w, c = features.shape
    j = joints_crop.shape[1]
    flat = features.reshape(n, h * w, c)
    cells = _gt_heatmap_cells(joints_crop, feat_stride, h)
    gt_feats = _take_rows(flat, cells[..., 1] * w + cells[..., 0])  # [N, J, C]
    vis = joints_vis.to(features.dtype)
    eye = torch.eye(n, dtype=features.dtype, device=features.device)
    pair_mask = vis.T[:, :, None] * vis.T[:, None, :] * (1 - eye)[None]  # [J, N, N]
    gj = gt_feats.transpose(0, 1)  # [J, N, C]
    low_pos_gt = gj[:, :, None, :].expand(j, n, n, c).reshape(-1, c)
    high_pos_gt = gj[:, None, :, :].expand(j, n, n, c).reshape(-1, c)
    all_feats = flat.reshape(-1, c)
    bg = draws["bg"]
    low_pos = torch.cat([low_pos_gt, all_feats[bg[:positive_num]]])
    high_pos = torch.cat([high_pos_gt, all_feats[bg[positive_num:]]])
    pos_mask = torch.cat([pair_mask.reshape(-1),
                          torch.ones(positive_num, dtype=vis.dtype, device=vis.device)])
    low_neg = all_feats[draws["neg"].reshape(-1)]  # [N*J*Q, C]
    high_neg = torch.repeat_interleave(gt_feats.reshape(n * j, c), neg_per_pos, dim=0)
    neg_mask = torch.repeat_interleave(vis.reshape(-1), neg_per_pos)
    return low_pos, high_pos, pos_mask, low_neg, high_neg, neg_mask


def masked_jsd_loss(pos_scores, pos_mask, neg_scores, neg_mask):
    """The JSD measure over masked samples (the dense joint-specific pairs)."""
    e_pos = LOG2 - F.softplus(-pos_scores)
    e_neg = F.softplus(-neg_scores) + neg_scores - LOG2
    ep = (e_pos * pos_mask).sum() / torch.clamp(pos_mask.sum(), min=1.0)
    en = (e_neg * neg_mask).sum() / torch.clamp(neg_mask.sum(), min=1.0)
    return en - ep


def local_infonce_loss(pos_scores, neg_scores, neg_per_pos: int):
    """MILoss.get_infonce_loss (loss.py:476-486): pos [N, P], neg [N, Q*P]."""
    n, p = pos_scores.shape
    scores = torch.cat([pos_scores[:, None, :], neg_scores.reshape(n, neg_per_pos, p)], dim=1)
    return -torch.log_softmax(scores, dim=1)[:, 0, :].mean()


def contrastive_gradient_penalty(score_fn: Callable, inputs, create_graph: bool = True):
    """Mescheder's gradient penalty (loss.py:488-522): the squared norm of
    the critic's summed scores' gradient with respect to the first input
    (the inputs detached), averaged over its leading axis. With
    ``create_graph`` the penalty is differentiable with respect to the
    critic's parameters (its discriminator side); without, a value."""
    xs = [x.detach().requires_grad_(i == 0) for i, x in enumerate(inputs)]
    with torch.enable_grad():
        (g,) = torch.autograd.grad(score_fn(*xs).sum(), xs[0], create_graph=create_graph)
    return (g.reshape(g.shape[0], -1) ** 2).sum(dim=1).mean()


def local_mi_loss(d, low, high, joints_crop, joints_vis, cfg, draws: dict):
    """One view's local MI loss (MILoss.__call__, loss.py:525-561): the
    pairs, the critic ``d`` (a LocalDiscriminator) on them, the measure and
    the gradient penalty, which is differentiable with respect to whichever
    of ``d``'s parameters require grad. draws from
    :func:`sample_local_pairs`."""
    measure, specific = cfg.LOSS.MI_MEASURE, cfg.LOSS.SPECIFIC
    positive_num, neg_per_pos = int(cfg.LOSS.MI_POSITIVE_NUM), int(cfg.LOSS.MI_NEG_POS_RATIO)
    stride = _feat_stride(cfg)
    create_graph = torch.is_grad_enabled() and any(p.requires_grad for p in d.parameters())

    def gp(a, b):
        return contrastive_gradient_penalty(d, [a, b], create_graph=create_graph)

    if specific in ("org", "one_image"):
        low_pos, high_pos, low_neg, high_neg = extract_local_pairs_org(
            low, high, joints_crop, stride, positive_num, neg_per_pos, draws,
            cross_image=specific == "org")
        pos_scores, neg_scores = d(low_pos, high_pos), d(low_neg, high_neg)  # [N, P], [N, Q*P]
        penalty = 0.5 * (gp(low_pos, high_pos) + gp(low_neg, high_neg))
        if measure == "NCE":
            return local_infonce_loss(pos_scores, neg_scores, neg_per_pos) + penalty
        return fenchel_dual_loss(pos_scores, neg_scores, measure) + penalty
    if specific == "joint":
        low_pos, high_pos, pos_mask, low_neg, high_neg, neg_mask = extract_local_pairs_joint(
            high, joints_crop, joints_vis, stride, positive_num, neg_per_pos, draws)
        # the critic on [L, C] pair lists, one batch of L positions each
        pos_scores = d(low_pos[None], high_pos[None])[0]
        neg_scores = d(low_neg[None], high_neg[None])[0]
        penalty = 0.5 * (gp(low_pos[None], high_pos[None]) + gp(low_neg[None], high_neg[None]))
        return masked_jsd_loss(pos_scores, pos_mask, neg_scores, neg_mask) + penalty
    raise ValueError(f"unknown LOSS.SPECIFIC {specific}")


# ----------------------------------------------------------- view / joints MI


def view_mi_loss(d, joints_2d, view1_num: int, measure: str):
    """MI between two view subsets' 2D joints (ViewMILoss, loss.py:
    564-594): joints_2d [N, V, J, 2] image coords; ``d`` a
    ViewDiscriminator."""
    n = joints_2d.shape[0]
    e1, e2 = d(joints_2d[:, :view1_num].reshape(n, -1), joints_2d[:, view1_num:].reshape(n, -1))
    return infonce_paired(e1, e2) if measure == "NCE" else jsd_paired(e1, e2)


def joints_mi_loss(d, joints_2d, var1_idx, measure: str, var2_stop_gradient: bool = False):
    """MI between two joint subsets of one view's 2D coords (JointsMILoss,
    loss.py:597-633): joints_2d [N, J, 2]; the second subset is every joint
    not in ``var1_idx``, in order; ``d`` a JointsDiscriminator."""
    j = joints_2d.shape[1]
    var1 = [int(i) for i in var1_idx]
    var2 = [i for i in range(j) if i not in var1]
    x1, x2 = joints_2d[:, var1], joints_2d[:, var2]
    if var2_stop_gradient:
        x2 = x2.detach()
    n = joints_2d.shape[0]
    e1, e2 = d(x1.reshape(n, -1), x2.reshape(n, -1))
    return infonce_paired(e1, e2) if measure == "NCE" else jsd_paired(e1, e2)


# ---------------------------------------------------------------- heatmap MI


def heatmap_mi_loss(d, features, heatmaps, idx, cfg, joint_idx: int):
    """MI between the heatmap's value at a cell and the image feature there
    (HeatmapMILoss, loss.py:636-780), one view: features [N, h, w, C],
    heatmaps [N, h, w, J], idx [N, Q] the cells of
    :func:`sample_heatmap_cells`; ``d`` a HeatmapDiscriminator. Every pair
    (heatmap at cell b, feature at cell a) is scored, [N*Q*Q, 1+C]: the
    diagonal pairs are the positives. NCE fills the negatives' diagonal with
    -10; JSD averages the two expectations over the pairs."""
    n, h, w, c = features.shape
    q = idx.shape[1]
    sampled_low = _take_rows(features.reshape(n, h * w, c), idx)  # [N, Q, C]
    sampled_hm = torch.gather(heatmaps[..., joint_idx].reshape(n, h * w), 1, idx)
    hm_grid = sampled_hm[:, None, :, None].expand(n, q, q, 1)
    ft_grid = sampled_low[:, :, None, :].expand(n, q, q, c)
    dt = torch.promote_types(heatmaps.dtype, features.dtype)
    pairs = torch.cat([hm_grid.to(dt), ft_grid.to(dt)], dim=-1).reshape(n * q * q, 1 + c)
    scores = d(pairs).reshape(n, q, q)
    eye = torch.eye(q, dtype=scores.dtype, device=scores.device)
    if cfg.LOSS.HEATMAP_MI_MEASURE == "NCE":
        diag = torch.diagonal(scores, dim1=1, dim2=2)
        logits = torch.cat([diag[..., None], scores * (1 - eye) - 10.0 * eye], dim=2)
        return -torch.log_softmax(logits, dim=2)[:, :, 0].mean()
    e_pos = LOG2 - F.softplus(-scores)
    e_neg = F.softplus(-scores) + scores - LOG2
    ep = (e_pos * eye).sum() / (eye.sum() * n)
    en = (e_neg * (1 - eye)).sum() / ((1 - eye).sum() * n)
    return en - ep


# ---------------------------------------------------------------- domain GAN


def _domain_scores(d, low_features):
    """The critic's patch map averaged to one score per image: low_features
    [N, V, h, w, C] -> [N*V] (the reference squeezes an [N, 1, 1, 1] map)."""
    flat = low_features.reshape((-1,) + low_features.shape[2:])
    out = d(flat)
    return out.reshape(out.shape[0], -1).mean(dim=1)


def domain_d_loss(d, low_features, is_mpii, smooth: float = 0.1):
    """The domain GAN's discriminator side (function.py:233-248) on the
    detached features [N, V, h, w, C]; is_mpii [N]. Returns (BCE, accuracy).

    The reference computes (0.1, 0.9) smoothed labels on one line and
    overwrites them on the next (function.py:237-238): the labels in effect
    are mpii -> 1.0, h36m -> 0.1, reproduced as they are."""
    label = torch.repeat_interleave(is_mpii, low_features.shape[1])
    scores = _domain_scores(d, low_features.detach())
    acc = ((scores >= 0.5) == (label > 0.5)).float().mean()
    return bce_loss(scores, label + (1.0 - label) * smooth), acc


def domain_g_loss(d, low_features, is_mpii):
    """The generator side: the labels inverted (function.py:250-257)."""
    label = 1.0 - torch.repeat_interleave(is_mpii, low_features.shape[1])
    return bce_loss(_domain_scores(d, low_features), label)
