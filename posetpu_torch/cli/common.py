"""Shared CLI plumbing: argument and config parsing, the model, and its
weights from a checkpoint."""

from __future__ import annotations

import argparse

from posetpu_torch.config import load_config, update_dir


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--modelDir", default="", help="model directory")
    p.add_argument("--logDir", default="", help="log directory")
    p.add_argument("--dataDir", default="", help="data directory")
    return p


def load_cfg(args, **overrides):
    cfg = load_config(args.cfg, **overrides)
    update_dir(cfg, args.modelDir, args.logDir, args.dataDir)
    return cfg


def build_model(cfg, bf16: bool = True, generator=None):
    """The MultiViewPose of ``cfg`` (the bank where NETWORK.AGGRE), its
    backbone computing in bf16 (or f32), its weights drawn from
    ``generator`` (models/multiview.get_multiview_pose_net), on the CPU."""
    import torch

    from posetpu_torch.models.multiview import get_multiview_pose_net

    return get_multiview_pose_net(cfg, generator, torch.bfloat16 if bf16 else torch.float32)


def load_model_variables(path: str, drop_aggre: bool = False) -> dict:
    """A model's {"params", "batch_stats"} (state-dict entries, CPU tensors)
    from one of the port's checkpoints (train/checkpoint.py): ``path`` is
    ``<dir>/<name>`` or ``<dir>/<name>.pt``, as the train CLI writes
    ``<output dir>/final_state.pt``; its base model is read, never its
    optimizer state. ``drop_aggre`` leaves the bank out.

    The port reads no other format: a reference ``.pth`` / ``.pth.tar``
    needs models/convert_torch.py (not ported yet, ROADMAP A6), and an
    Orbax directory written by the JAX package is refused."""
    import os

    from posetpu_torch.train.checkpoint import CheckpointManager

    if path.endswith((".pth", ".pth.tar")):
        raise NotImplementedError(
            f"{path}: a reference torch checkpoint needs models/convert_torch.py, which is "
            f"not ported yet (ROADMAP A6)")
    stem = path[:-3] if path.endswith(".pt") else path
    if not os.path.isfile(stem + ".pt"):
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an Orbax checkpoint of the JAX package?): the port "
                f"reads its own checkpoints, <dir>/<name>.pt")
        raise FileNotFoundError(f"no checkpoint {stem}.pt")
    states = CheckpointManager(os.path.dirname(os.path.abspath(stem))).restore_model(
        os.path.basename(stem))
    base = states.get("base_model", next(iter(states.values())))
    keep = lambda k: not (drop_aggre and k.startswith("aggre_layer."))
    return {part: {k: v for k, v in base[part].items() if keep(k)}
            for part in ("params", "batch_stats")}
