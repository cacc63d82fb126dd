"""The train state of one model."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """Parameters, BN statistics, optimizer state and step of one model.

    ``params`` is the module itself: it holds the parameters and, as
    buffers, the BN running statistics (:attr:`batch_stats`). ``opt_state``
    is its optimizer's (train/optim.py), keyed by parameter name. A train
    step advances all of them in place and returns the state with ``step``
    one higher (the JAX package's TrainState is a pytree that each step
    replaces)."""

    params: nn.Module
    opt_state: Any
    step: int

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The BN running statistics by state-dict key."""
        return {k: v for k, v in self.params.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def state_dict(self) -> dict:
        """{"params", "batch_stats", "opt_state", "step"}: the tensors
        detached, where they live."""
        sd = self.params.state_dict()
        stats = self.batch_stats
        return {"params": {k: v for k, v in sd.items() if k not in stats},
                "batch_stats": stats, "opt_state": self.opt_state, "step": self.step}

    def load_state_dict(self, d: dict) -> None:
        """Load a :meth:`state_dict` (from a checkpoint, say) in place, each
        tensor onto the device and dtype it replaces. The keys must be this
        state's, no more and no fewer, in the module and in the optimizer
        state (as orbax refuses a template that does not match): else
        ValueError, naming the missing and the unexpected keys."""
        model = {**d["params"], **d["batch_stats"]}
        _same_keys(model, self.params.state_dict(), "params")
        opt_state = _like(d["opt_state"], self.opt_state, "opt_state")
        self.params.load_state_dict(model)
        self.opt_state = opt_state
        self.step = int(d["step"])


def _same_keys(src: dict, ref: dict, where: str) -> None:
    missing, unexpected = sorted(set(ref) - set(src)), sorted(set(src) - set(ref))
    if missing or unexpected:
        raise ValueError(f"the checkpoint does not match the template at {where}: "
                         f"missing keys {missing}, unexpected keys {unexpected}")


def _like(src, ref, where: str):
    """``src``'s values in ``ref``'s structure (the same keys, else
    ValueError), tensors moved to the device and dtype of ``ref``'s."""
    if isinstance(ref, dict):
        _same_keys(src, ref, where)
        return {k: _like(src[k], v, f"{where}.{k}") for k, v in ref.items()}
    if isinstance(ref, torch.Tensor):
        return src.to(device=ref.device, dtype=ref.dtype)
    return type(ref)(src)
