"""Per-loss gradient-norm probe (lib/utils/gradients.py:16-40, called from
lib/core/function.py:352-362 under ``LOSS.WATCH_GRAD_NORM``): for each loss
term, its gradient with respect to the raw heatmaps, reduced per view to the
mean row norm over the nonzero rows, summed over the views."""

from __future__ import annotations

from typing import Callable, Mapping

import torch


def grad_norms_wrt_heatmaps(loss_fns: Mapping[str, Callable], heatmaps,
                            ord: int = 1) -> dict:
    """loss_fns {name: fn(heatmaps) -> scalar}; heatmaps [N, ...] or
    [N, V, ...]. Returns {name: 0-d tensor}: per view the per-sample
    ``ord``-norms of the gradient averaged over the nonzero ones, summed
    over the views."""
    out = {}
    for name, fn in loss_fns.items():
        r = heatmaps.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(fn(r), r)
        rows = g.reshape(g.shape[0], g.shape[1] if g.dim() > 2 else 1, -1)
        norms = torch.linalg.vector_norm(rows, ord=ord, dim=-1)  # [N, V]
        nonzero = (norms > 0).float()
        out[name] = (norms.sum(0) / torch.clamp(nonzero.sum(0), min=1.0)).sum()
    return out
