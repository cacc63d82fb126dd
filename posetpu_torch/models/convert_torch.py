"""The reference's PyTorch checkpoints -> the port's state dicts.

Reads the reference's checkpoints (``resnet50-19c8e357.pth`` ImageNet
backbones, ``final_state.pth.tar`` / ``checkpoint.pth.tar`` training states,
reference: run/pose2d/train.py:250-286) and gives the variables of
:class:`~posetpu_torch.models.pose_resnet.PoseResNet` /
:class:`~posetpu_torch.models.multiview.MultiViewPose` as
cli/common.load_model_variables returns them: {"params": state-dict
entries, "batch_stats": the BatchNorm running statistics}, CPU tensors in
f32.

The port's modules keep the reference's layouts (``nn.Conv2d`` OIHW,
``nn.ConvTranspose2d`` [I, O, kh, kw], BatchNorm weight / bias / running
statistics), so the conversion is a renaming:

* ``layer{s}.{b}.`` -> ``layer{s}_{b}.``; ``downsample.0`` / ``.1`` ->
  ``downsample_conv`` / ``downsample_bn``;
* ``deconv_layers.{3k}`` / ``{3k+1}`` -> ``deconv{k}_conv`` / ``deconv{k}_bn``;
* the 12 ``aggre_layer.aggre.{i}.weight`` [S, S] stacked into the
  ``aggre_layer.weight`` bank [12, S, S];
* ``fc.*`` (ImageNet's classifier) and the reference's
  ``num_batches_tracked`` dropped; each BatchNorm gets a
  ``num_batches_tracked`` of 0, as a fresh module has.

A key that maps nowhere is returned in the ``unused`` list, the JAX
package's list for the same checkpoint.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def load_torch_state(path: str) -> dict[str, torch.Tensor]:
    """A .pth / .pth.tar file as a flat state dict of CPU tensors, the
    reference's checkpoint envelope (``state_dict_base_model`` or
    ``state_dict``) and DDP's ``module.`` prefixes unwrapped. The file is
    unpickled in full (``weights_only=False``, the envelope holds more than
    tensors): read only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict_base_model" in obj:
        obj = obj["state_dict_base_model"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): torch.as_tensor(v).detach() for k, v in obj.items()}


def _bn(module: str, leaf: str, val, out: dict) -> bool:
    """A BatchNorm entry: weight / bias / running statistics kept under
    ``module``, the reference's ``num_batches_tracked`` dropped."""
    if leaf in _BN_LEAVES:
        out[f"{module}.{leaf}"] = val
        return True
    return leaf == "num_batches_tracked"


def _convert_one(parts: list[str], val, out: dict) -> bool:
    """One reference entry into ``out`` under the port's name; False where
    it maps nowhere (the JAX package's rules, key for key)."""
    if parts[0] == "conv1" and parts[1] == "weight":
        out["conv1.weight"] = val
        return True
    if parts[0] == "bn1":
        return _bn("bn1", parts[1], val, out)

    m = re.fullmatch(r"layer(\d)", parts[0])
    if m:  # residual stages: layer{s}.{b}.<leaf>
        block = f"layer{m.group(1)}_{parts[1]}"
        rest = parts[2:]
        if rest[0].startswith("conv") and rest[1] == "weight":
            out[f"{block}.{rest[0]}.weight"] = val
            return True
        if rest[0].startswith("bn"):
            return _bn(f"{block}.{rest[0]}", rest[1], val, out)
        if rest[0] == "downsample":
            if rest[1] == "0" and rest[2] == "weight":
                out[f"{block}.downsample_conv.weight"] = val
                return True
            if rest[1] == "1":
                return _bn(f"{block}.downsample_bn", rest[2], val, out)
        return False

    if parts[0] == "deconv_layers":  # Sequential 0, 3, 6 = deconv; 1, 4, 7 = BN
        stage, role = divmod(int(parts[1]), 3)
        if role == 0 and parts[2] in ("weight", "bias"):
            out[f"deconv{stage}_conv.{parts[2]}"] = val
            return True
        if role == 1:
            return _bn(f"deconv{stage}_bn", parts[2], val, out)
        return False

    if parts[0] == "final_layer" and parts[1] in ("weight", "bias"):
        out[f"final_layer.{parts[1]}"] = val
        return True
    # torchvision's ImageNet extras, deliberately dropped
    return parts[0] == "fc" or parts[-1] == "num_batches_tracked"


def _split(flat: dict, prefix: str = "") -> dict:
    """Flat port entries -> {"params", "batch_stats"} under ``prefix``, every
    floating tensor in f32, each BatchNorm with a ``num_batches_tracked``
    of 0."""
    params, stats = {}, {}
    for k, v in flat.items():
        if k.endswith(("running_mean", "running_var")):
            stats[prefix + k] = v.float()
            if k.endswith("running_mean"):
                params[prefix + k[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.int64))
        else:
            params[prefix + k] = v.float()
    return {"params": params, "batch_stats": stats}


def convert_pose_resnet(state: Mapping[str, torch.Tensor], strict: bool = False):
    """A (possibly partial) reference PoseResNet state dict -> (variables,
    unused): the port's {"params", "batch_stats"} and the reference keys
    that map nowhere. ``strict``: ValueError if any key is unused."""
    flat: dict = {}
    unused = [k for k, v in state.items() if not _convert_one(k.split("."), v, flat)]
    if strict and unused:
        raise ValueError(f"unconsumed torch keys: {unused[:10]} "
                         f"(+{max(len(unused) - 10, 0)})")
    return _split(flat), unused


def convert_multiview(state: Mapping[str, torch.Tensor], drop_aggre: bool = False):
    """A reference MultiViewPose state dict -> (variables, unused): the
    ``resnet.*`` keys through :func:`convert_pose_resnet`, the
    ``aggre_layer.aggre.{i}.weight`` stacked into the [12, S, S] bank
    (left out with ``drop_aggre``, as the reference prunes it for
    AGGRE=false resumes, train.py:262-275)."""
    resnet = {k.removeprefix("resnet."): v for k, v in state.items() if k.startswith("resnet.")}
    flat: dict = {}
    unused = [k for k, v in resnet.items() if not _convert_one(k.split("."), v, flat)]
    variables = _split(flat, "resnet.")
    fc = {}
    for k, v in state.items():
        m = re.fullmatch(r"aggre_layer\.aggre\.(\d+)\.weight", k)
        if m and not drop_aggre:
            fc[int(m.group(1))] = v
        elif not k.startswith("resnet.") and not m:
            unused.append(k)
    if fc:
        variables["params"]["aggre_layer.weight"] = torch.stack(
            [fc[i].float() for i in range(len(fc))])
    return variables, unused
