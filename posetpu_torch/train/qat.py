"""Quantization-aware fine-tuning for the int8 serving trunk.

Post-training quantization of a trained checkpoint costs accuracy, most of
it at the extremity joints in the JAX package's measurements. QAT repairs
it the standard way: fine-tune the BN-folded
float weights through a fake-quantized forward whose quantization points
are exactly those of the int8 runner (models/quant.py:_Int8Runner: int8
activations between convs, per-output-channel int8 weights), with
straight-through gradients through the rounding and the clip.

No labels are needed: by default the objective distills the float trunk's
own heatmaps (the teacher is the same folded weights without fake quant),
so QAT runs on any images, the unlabelled serving distribution included.
The arithmetic is the JAX package's: ``round(x / scale)`` divides, the
weight scale is recomputed from the live weights every step, and the folded
weights step by optax's Adam (train/optim.py) at a constant learning rate.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from posetpu_torch import resolve_device
from posetpu_torch.models.quant import (
    _conv_f32,
    _deconv_f32,
    _forward,
    _full_fp32,
    _Int8Runner,
    _nchw,
    _nhwc,
    _Recorder,
    calibrate,
    quantize_weights,
)
from posetpu_torch.train.optim import Optimizer


def _fake_quant(x, scale):
    """Symmetric int8 quantize-dequantize with a straight-through gradient:
    the value of ``clip(round(x / scale), -127, 127) * scale``, the gradient
    of the identity (none reaches ``scale``). ``scale`` is a tensor on x's
    device: a Python float divisor is a multiply by its reciprocal on CUDA,
    which rounds otherwise."""
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


def _key(site: str) -> str:
    """A parameter's name may not hold "."; the sites' names do."""
    return site.replace(".", "/")


class FoldedParams(nn.Module):
    """The folded trunk's float weights as parameters: site name -> (HWIO
    kernel, bias), in :func:`~posetpu_torch.models.quant.fold_params`'
    layout (deconv kernels spatially flipped). They are copies of
    ``folded``'s arrays, in their dtype."""

    def __init__(self, folded: dict, device):
        super().__init__()
        t = lambda a: nn.Parameter(torch.tensor(a, device=device))  # noqa: E731
        self.kernels = nn.ParameterDict({_key(k): t(w) for k, (w, _) in folded.items()})
        self.biases = nn.ParameterDict({_key(k): t(b) for k, (_, b) in folded.items()})

    def __getitem__(self, name: str):
        return self.kernels[_key(name)], self.biases[_key(name)]

    def numpy(self) -> dict:
        """{site: (kernel, bias)} as numpy f32, as fold_params gives them."""
        f32 = lambda p: p.detach().float().cpu().numpy()  # noqa: E731
        return {k.replace("/", "."): (f32(w), f32(self.biases[k]))
                for k, w in self.kernels.items()}


class _FakeQuantRunner:
    """Float executor over the live folded weights with a quantize-dequantize
    at every point where the int8 runner carries an int8 tensor. Activation
    scales are the calibrated constants the serving graph uses; weight
    scales are recomputed from the live weights (per output channel, as
    quantize_weights does). It runs the calibration recorder's plan (no
    ``q``: the 7x7/s2 stem, every deconv as the float transposed conv, the
    dilated conv's equal); a subpixel deconv is refused, as the JAX package
    asserts."""

    def __init__(self, params, act_scales: dict):
        self.p = params
        w = next(iter(params.parameters()))
        # a Python float scale takes the weights' dtype, as a weak-typed one
        # does in JAX
        self.s = {k: torch.as_tensor(v, dtype=w.dtype, device=w.device)
                  for k, v in act_scales.items()}
        self._127 = torch.tensor(127.0, dtype=w.dtype, device=w.device)

    def _fq_w(self, w):
        s = torch.clamp(w.abs().amax(dim=(0, 1, 2), keepdim=True), min=1e-8) / self._127
        return _fake_quant(w, s)

    def _fq_a(self, x, name):
        return _fake_quant(x, self.s[name])

    def input(self, x):
        return self._fq_a(x, "input"), None

    def qchain(self, h, s_h, name, stride=1, relu=True, deconv=False, subpixel=False):
        if subpixel:
            raise ValueError(f"{name}: QAT runs the dilated-conv plan; subpixel deconvs "
                             f"are PTQ-only")
        w, b = self.p[name]
        if deconv:
            y = _deconv_f32(h, self._fq_w(w)) + b
        else:
            y = _conv_f32(h, self._fq_w(w), stride=stride) + b
        if relu:
            y = torch.relu(y)
        return self._fq_a(y, f"{name}.out"), None

    def conv_f32(self, h, s_h, name, stride=1):
        w, b = self.p[name]
        return _conv_f32(h, self._fq_w(w), stride=stride) + b

    def block_out(self, m, s_m, conv, r, r_s, name):
        return self.requant(torch.relu(self.conv_f32(m, s_m, conv) + self.dequant(r, r_s)), name)

    def max_pool(self, h):
        # PyTorch's pooling sends the gradient to the first maximum of a
        # window, as XLA's max-pool gradient does (torch.maximum splits ties)
        return _nhwc(F.max_pool2d(_nchw(h), 3, 2, 1))

    def dequant(self, h, s_h):
        return h

    def requant(self, y, name):
        return self._fq_a(y, name), None

    def unwrap(self, h, s_h):
        return h, s_h


def qat_finetune(model, calib_batches: Iterable[Any], train_batches: Iterable[Any], *,
                 lr: float = 3e-6, target_fn=None, device=None) -> tuple[dict, dict]:
    """Fine-tune the folded trunk through fake quantization.

    Args:
        model: the float PoseResNet holding its trained weights.
        calib_batches: [N, H, W, 3] float batches for activation calibration.
        train_batches: [N, H, W, 3] float batches to fine-tune on, one Adam
            step each (iterate epochs outside).
        lr: Adam's learning rate (optax.adam(lr): b1 0.9, b2 0.999, eps
            1e-8). Keep it small: Adam's first steps move every folded weight
            by about lr, and 1e-4 blew the loss up 80x on a ResNet-18 trunk
            in the JAX package's measurements; 3e-6 is its stable default.
        target_fn: optional ``batch -> target heatmaps``; by default the
            float teacher's own heatmaps on the same batch.
        device: CUDA unless given. On CUDA the convolutions run in full f32
            (cuDNN's TF32 default would move fake-quantised values across
            rounding boundaries).

    Returns:
        (qparams, info): serving qparams (quantize_weights' schema, for
        ``_Int8Runner`` and train/serve.make_quant_eval_step) and
        {"losses": [one float a step]}."""
    dev = resolve_device(device)
    folded, act_scales = calibrate(model, calib_batches, dev)
    return _finetune(folded, act_scales, model.num_layers, model.deconv_kernels,
                     train_batches, lr=lr, target_fn=target_fn, device=dev)


def _finetune(folded: dict, act_scales: dict, num_layers: int, deconv_kernels,
              train_batches, *, lr: float, target_fn, device):
    """:func:`qat_finetune` after the calibration: Adam steps on the folded
    weights (``folded`` and ``act_scales`` as calibrate returns them), then
    the int8 conversion of the tuned weights, rounded to f32 first.
    The steps compute in the dtype of ``folded``'s arrays. float64 ones
    hold the steps against another implementation: in f32 one activation
    that a conv sum in another order rounds the other way moves the next
    layers' fake-quantised values, and the difference spreads through the
    trunk."""
    params = FoldedParams(folded, device)
    dtype = next(iter(params.parameters())).dtype
    teacher = _Recorder({k: tuple(t.detach().clone() for t in params[k]) for k in folded},
                        device)
    scales = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in act_scales.items()}
    tx = Optimizer("adam", lambda count: lr)
    opt_state = tx.init(params)
    losses = []
    with _full_fp32():
        for batch in train_batches:
            x = torch.as_tensor(batch, dtype=dtype, device=device)
            if target_fn is not None:
                target = torch.as_tensor(target_fn(batch), dtype=dtype, device=device)
            else:
                with torch.no_grad():
                    target = _forward(teacher, x, num_layers, deconv_kernels)
            params.zero_grad(set_to_none=True)
            out = _forward(_FakeQuantRunner(params, scales), x, num_layers, deconv_kernels)
            loss = torch.mean(torch.square(out - target))
            loss.backward()
            tx.update(params, opt_state)
            losses.append(loss.detach())
    qparams = quantize_weights(params.numpy(), act_scales, device=device)
    return qparams, {"losses": [float(v) for v in losses]}


def quantize_pose_resnet_qat(model, calib_batches, train_batches, lr: float = 3e-6,
                             device=None):
    """QAT twin of models/quant.quantize_pose_resnet: (qparams, forward,
    info) with the weights fake-quant fine-tuned (:func:`qat_finetune`);
    ``forward(qparams, x)``: x [N, H, W, 3] -> f32 heatmaps [N, h, w, J]
    through the int8 runner (no act4 boundary, every deconv the dilated int8
    conv). CUDA unless ``device`` is given."""
    qparams, info = qat_finetune(model, calib_batches, train_batches, lr=lr, device=device)
    nl, dks = model.num_layers, tuple(int(k) for k in model.deconv_kernels)

    @torch.no_grad()
    def forward(qparams, x):
        return _forward(_Int8Runner(qparams), x, nl, dks)

    return qparams, forward, info
