"""Training-mode BatchNorm over the global batch of a data mesh.

The JAX train step computes BatchNorm's moments over the global batch on
purpose (posetpu/train/step.py:10-13). Here each rank sums its own rows and
one all-reduce joins the sums: :func:`global_batch_norm`, an autograd
Function with one all-reduce forward and one backward.

A step opts in by running its forward inside :func:`sync_batch_stats`
(train/step.py and train/gan.py do so with their ``mesh``):
models/pose_resnet.BatchNorm reads :func:`batch_stats_mesh` and, under a
mesh, makes those two collectives per layer. Outside that block, or with
``mesh=None``, BatchNorm normalises by the local batch as before.

This module imports only parallel/mesh.py's collectives, so the model
layer depends on nothing of train/.
"""

from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from posetpu_torch.parallel.mesh import DataMesh, _all_reduce_

_BN_MESH: contextvars.ContextVar = contextvars.ContextVar("posetpu_bn_mesh", default=None)


@contextmanager
def sync_batch_stats(mesh: DataMesh | None):
    """Meanwhile a training-mode models/pose_resnet.BatchNorm takes its
    moments over the global batch (an all-reduce of its per-channel sums),
    as the JAX step computes them on purpose (posetpu/train/step.py:10-13).
    None: nothing changes."""
    token = _BN_MESH.set(mesh)
    try:
        yield
    finally:
        _BN_MESH.reset(token)


def batch_stats_mesh() -> DataMesh | None:
    """The mesh :func:`sync_batch_stats` set, or None."""
    return _BN_MESH.get()


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm of an NCHW ``x`` over every rank's batch.

    Forward: the per-channel sums of x and x^2 in at least f32 (one read of
    ``x`` each, the square sum as the squared 2-norm, so no widened copy)
    and the count, one all-reduce, Flax's ``mean(x)`` and ``mean(x^2) -
    mean(x)^2``; then ``x * scale + shift`` in one fused pass (F.batch_norm
    in eval form, running mean 0 and variance 1, its eps folded back into
    the scale). Backward: the local sums of dy and dy (x - mean) invstd in
    one fused reduction (native_batch_norm_backward), which are this
    rank's share of the weight's and bias's gradients; one all-reduce of
    them; then dx = A dy + B x + C with per-channel A, B, C from the global
    sums (BatchNorm's gradient through the global moments), in two passes.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        acc = torch.promote_types(x.dtype, torch.float32)
        c, dims = x.shape[1], (0, 2, 3)
        count = torch.full((1,), x.numel() // c, dtype=acc, device=x.device)
        total = _all_reduce_(torch.cat([
            x.sum(dims, dtype=acc), torch.linalg.vector_norm(x, 2, dims, dtype=acc).square(),
            count]), mesh)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        scale = weight.to(acc) * invstd
        zero, one = torch.zeros_like(mean), torch.ones_like(var)
        y = F.batch_norm(x, zero, one, scale * math.sqrt(1.0 + eps), bias.to(acc) - mean * scale,
                         False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.eps, ctx.mesh = eps, mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        acc = mean.dtype
        dy = dy.contiguous(memory_format=_format_of(x))
        _, g_weight, g_bias = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight.to(acc), None, None, mean, invstd, True, ctx.eps, [False, True, True])
        c = x.shape[1]
        total = _all_reduce_(torch.cat([g_weight, g_bias]).to(acc), ctx.mesh)
        a = weight.to(acc) * invstd
        b = -a * invstd * total[:c] / n
        shift = -a * total[c:] / n - b * mean
        zero, one = torch.zeros_like(mean), torch.ones_like(invstd)
        bx = F.batch_norm(x, zero, one, b * math.sqrt(1.0 + ctx.eps), shift, False, 0.0, ctx.eps)
        dx = torch.empty_like(x)
        torch.addcmul(bx, dy, a.view(1, -1, 1, 1), out=dx)
        return dx, g_weight.to(weight.dtype), g_bias.to(weight.dtype), None, None


def _format_of(x: torch.Tensor):
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)


def global_batch_norm(x, weight, bias, eps: float, mesh: DataMesh):
    """(y, mean, biased variance) of training-mode BatchNorm over every
    rank's batch (:class:`_GlobalBatchNorm`); y is differentiable with
    respect to ``x``, ``weight`` and ``bias`` (their gradients this rank's
    share), the moments are not."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps, mesh)
