"""posetpu_torch — the multi-view pose system in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

Module names mirror the JAX package's, so each counterpart is easy to find.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper takes its plain PyTorch version instead.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted and absent — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
