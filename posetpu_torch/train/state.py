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
        tensor onto the device and dtype it replaces."""
        self.params.load_state_dict({**d["params"], **d["batch_stats"]}, strict=False)
        self.opt_state = _like(d["opt_state"], self.opt_state)
        self.step = int(d["step"])


def _like(src, ref):
    """``src``'s values in ``ref``'s structure, tensors moved to the
    device and dtype of ``ref``'s."""
    if isinstance(ref, dict):
        return {k: _like(src[k], v) for k, v in ref.items()}
    if isinstance(ref, torch.Tensor):
        return src.to(device=ref.device, dtype=ref.dtype)
    return type(ref)(src)
