"""Weight bridge from the JAX package's variables and serving params.

:func:`from_jax_variables` is the inverse of the JAX package's
``models/convert_torch.py:convert_multiview``: a numpy tree of Flax
variables -> a state dict for :class:`~posetpu_torch.models.multiview.
MultiViewPose` (or, for a tree without a ``resnet`` subtree, for
:class:`~posetpu_torch.models.pose_resnet.PoseResNet`):

* HWIO conv kernel [kh, kw, I, O] -> OIHW [O, I, kh, kw];
* the spatially flipped HWIO ConvTranspose kernel -> the unflipped
  ConvTranspose2d [I, O, kh, kw];
* BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var;
* the stacked [12, S, S] aggregation bank as it is.

:func:`from_jax_critic_variables` does the same for a module whose port
keeps Flax's submodule names (the critics of models/discriminators.py):
a Dense kernel [I, O] -> ``nn.Linear``'s [O, I], an HWIO conv kernel -> OIHW
(a 1x1 one -> [O, I] where the port computes it as an ``nn.Linear``),
LayerNorm and BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
running_mean/running_var.

:func:`from_jax_train_state` carries a JAX train state (params, batch
statistics and optax Adam's moments) into the port's, so both packages can
step from one state; :func:`from_jax_train_states` a dict of them (the
adversarial step's base model and critics).

:func:`from_jax_params` turns a JAX serving pipeline's params
({"q": qparams, "qagg": bank}) or a JAX ``make_fused_forward``'s
({"q", "fused", "deconv"}), as numpy, into the port's, so a test can hand the
same quantized state to both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from posetpu_torch import resolve_device
from posetpu_torch.ops import aggregation as _agg
from posetpu_torch.ops import deconv as _dc
from posetpu_torch.ops import phase_tail as _pt
from posetpu_torch.ops import resblock as _rb


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_jax_variables(tree) -> dict[str, torch.Tensor]:
    """Flax variables ({"params", "batch_stats"}, numpy leaves) -> a torch
    state dict (load it with ``module.load_state_dict``)."""
    sd = {}
    for path, v in _flatten(tree["params"]):
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            if path[-2].startswith("deconv") and path[-2].endswith("_conv"):
                w = v[::-1, ::-1].transpose(2, 3, 0, 1)  # -> [I, O, kh, kw]
            else:
                w = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            sd[f"{module}.weight"] = w
        elif leaf in ("scale", "weight"):  # BN scale, aggregation bank
            sd[f"{module}.weight"] = v
        elif leaf == "bias":
            sd[f"{module}.bias"] = v
        else:
            raise ValueError(f"unknown variable {'/'.join(path)}")
    for path, v in _flatten(tree.get("batch_stats", {})):
        module, leaf = ".".join(path[:-1]), path[-1]
        sd[f"{module}.running_{leaf}"] = v
        sd[f"{module}.num_batches_tracked"] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def from_jax_critic_variables(tree, module) -> dict[str, torch.Tensor]:
    """Flax variables ({"params"[, "batch_stats"]}, numpy leaves) of a
    critic -> a state dict for ``module``, its port (the layouts are read off
    ``module``'s own tensors)."""
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    sd = {}
    for path, v in _flatten(tree["params"]):
        module_name, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            key = f"{module_name}.weight"
            w = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)  # [I, O] / HWIO -> OIHW
            sd[key] = w.reshape(shapes[key])
        elif leaf in ("scale", "bias"):
            sd[f"{module_name}.{ {'scale': 'weight'}.get(leaf, leaf)}"] = v
        else:
            raise ValueError(f"unknown variable {'/'.join(path)}")
    for path, v in _flatten(tree.get("batch_stats", {})):
        sd[f"{'.'.join(path[:-1])}.running_{path[-1]}"] = v
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def from_jax_params(tree, device=None) -> dict:
    """A JAX pipeline's params (numpy leaves) -> the port's params on
    ``device``: under "q" the trunk weights as int8 HWIO tensors (of any
    ``jns_head`` / ``stem_s2d``), scales as f32 tensors and the kernels'
    argument packs (``phase_tail2``, ``phase_tail``, ``subpix_*``); under
    "qagg" the bank (int8, or an s4 carrier nibble-packed); under "fused" and
    "deconv" a ``make_fused_forward``'s bottleneck and deconv (+ head)
    arguments; all in the kernels' layouts. A key the tree lacks is left out
    ("q" and "qagg" come back as None). CUDA unless ``device`` is given."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    out = {"q": None, "qagg": None}
    q = tree.get("q")
    if q is not None:
        qp = {k: {n: t(v) for n, v in q[k].items()}
              for k in ("weights", "w_scales", "biases")}
        qp["act_scales"] = {n: t(np.float32(v)) for n, v in q["act_scales"].items()}
        for k, v in q.items():
            if k == "phase_tail2":
                qp[k] = _pt.tail2_device_args(v, dev)
            elif k == "phase_tail":
                qp[k] = _pt.tail_device_args(v, dev)
            elif k.startswith("subpix_"):
                qp[k] = _pt.subpixel_device_args(v, dev)
            elif k not in qp:
                raise ValueError(f"unknown qparams entry {k!r}")
        out["q"] = qp
    qagg = tree.get("qagg")
    if qagg is not None:
        # an s4 bank (wq4, w_scale, dv, x_scale) becomes the nibble-packed one
        to_dev = (_agg.aggregation_device_params_s4 if "wq4" in qagg
                  else _agg.aggregation_device_params)
        out["qagg"] = to_dev(qagg, dev)
    if "fused" in tree:
        out["fused"] = {name: _rb.bottleneck_device_args(a, dev)
                        for name, a in tree["fused"].items()}
    if "deconv" in tree:
        out["deconv"] = [_dc.deconv_device_args(a, dev) for a in tree["deconv"]]
    return out


def _f32(tree):
    """A numpy tree with every leaf as f32 (a bf16 moment widens exactly;
    torch cannot take numpy's bf16)."""
    if isinstance(tree, Mapping):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def from_jax_train_state(state, model, tx, device=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) whose optimizer is optax.adam -> the port's
    :class:`~posetpu_torch.train.state.TrainState` for ``model`` (a
    MultiViewPose or a critic, the weights loaded into it strictly, moved to
    ``device``; its dtype kept) and ``tx`` (a train/optim.py Adam): the
    moments keyed and laid out as the parameters, in ``tx``'s dtypes, and
    the step count. CUDA unless ``device`` is given."""
    from posetpu_torch.models.multiview import MultiViewPose
    from posetpu_torch.models.pose_resnet import PoseResNet
    from posetpu_torch.train.state import TrainState

    dev = resolve_device(device)
    if isinstance(model, (MultiViewPose, PoseResNet)):
        convert = from_jax_variables
    else:
        convert = lambda tree: from_jax_critic_variables(tree, model)  # noqa: E731
    model.load_state_dict(convert({"params": state.params, "batch_stats": state.batch_stats}))
    model.to(dev)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))  # (adam, schedule)
    opt = tx.init(model)
    opt["count"] = int(adam.count)
    for k in ("mu", "nu"):
        carried = convert({"params": _f32(getattr(adam, k))})
        opt[k] = {n: carried[n].to(device=dev, dtype=t.dtype) for n, t in opt[k].items()}
    return TrainState(model, opt, int(state.step))


def from_jax_train_states(states: dict, models: dict, txs: dict, device=None) -> dict:
    """{name: JAX TrainState} (numpy leaves) -> {name: the port's
    TrainState}, each through :func:`from_jax_train_state` with
    ``models[name]`` and ``txs[name]``: the adversarial step's base model
    and critics."""
    return {k: from_jax_train_state(st, models[k], txs[k], device) for k, st in states.items()}
