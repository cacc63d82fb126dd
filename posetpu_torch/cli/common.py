"""Shared CLI plumbing: argument and config parsing, the launcher of a
host's ranks, the model, and its weights from a checkpoint."""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import threading

from posetpu_torch.config import load_config, update_dir


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", required=True, help="experiment YAML")
    p.add_argument("--modelDir", default="", help="model directory")
    p.add_argument("--logDir", default="", help="log directory")
    p.add_argument("--dataDir", default="", help="data directory")
    return p


def add_process_flags(p: argparse.ArgumentParser) -> None:
    """``--coordinator``, ``--num-processes``, ``--process-id``:
    ``jax.distributed.initialize``'s meaning, processes are hosts; each
    host's command starts one rank per visible GPU (:func:`launch`)."""
    p.add_argument("--coordinator", default="",
                   help="host:port of process 0, where the hosts meet")
    p.add_argument("--num-processes", type=int, default=0, help="hosts (processes)")
    p.add_argument("--process-id", type=int, default=0, help="this host's index")


def launch(fn, layout, *args, collect: bool = False):
    """``fn(layout, *args)`` in each of this host's ``layout.local_ranks``
    ranks (parallel/mesh.Layout; ``fn`` a module-level function, ``args``
    picklable): one rank runs in this process; more are spawned, one
    process each with its ``local`` index, meeting at ``layout.url`` or,
    with no coordinator, at a rendezvous file made here. Returns local rank
    0's value (of spawned ranks only with ``collect``, through a file).

    This process waits for the ranks. SIGTERM is passed on to each; when a
    rank fails, the others are stopped (SIGTERM, SIGKILL after 30 s) and
    the failure raised: the rank's traceback, or SystemExit with its exit
    code (128 + the signal for one killed by a signal)."""
    if layout.local_ranks == 1:
        return fn(layout, *args)
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="posetpu-ranks-")
    url = layout.url or f"file://{tmp}/rendezvous"
    result = os.path.join(tmp, "result.pt") if collect else None
    ranks = mp.start_processes(_local_rank, args=(fn, layout, url, args, result),
                               nprocs=layout.local_ranks, join=False, start_method="spawn")

    def pass_on(_sig, _frm):
        for p in ranks.processes:
            if p.is_alive():
                p.terminate()

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, pass_on) if main_thread else None
    try:
        try:
            while not ranks.join(timeout=1.0):
                pass
        except mp.ProcessExitedException as e:
            code = e.exit_code
            raise SystemExit(code if code > 0 else 128 - code) from e
        return torch.load(result, weights_only=False) if collect else None
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
        shutil.rmtree(tmp, ignore_errors=True)


def _local_rank(local, fn, layout, url, args, result):
    out = fn(dataclasses.replace(layout, local=local, url=url), *args)
    if result is not None and local == 0:
        import torch

        torch.save(out, result)


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
    from a checkpoint: a reference torch checkpoint (``.pth`` /
    ``.pth.tar``, converted by models/convert_torch.py; a bare PoseResNet's
    keys are nested under ``resnet.``), or one of the port's own
    (train/checkpoint.py), ``path`` being ``<dir>/<name>`` or
    ``<dir>/<name>.pt`` as the train CLI writes ``<output
    dir>/final_state.pt`` and cli/convert.py its output: its base model is
    read, never its optimizer state. ``drop_aggre`` leaves the bank out. An
    Orbax directory written by the JAX package is refused."""
    import os

    from posetpu_torch.train.checkpoint import CheckpointManager

    if path.endswith((".pth", ".pth.tar")):
        from posetpu_torch.models.convert_torch import convert_multiview, load_torch_state

        state = load_torch_state(path)
        if not any(k.startswith("resnet.") for k in state):
            state = {f"resnet.{k}": v for k, v in state.items()}
        variables, unused = convert_multiview(state, drop_aggre=drop_aggre)
        if unused:
            print(f"warning: {len(unused)} unconverted torch keys, e.g. {unused[:5]}")
        return variables
    stem = path[:-3] if path.endswith(".pt") else path
    if not os.path.isfile(stem + ".pt"):
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an Orbax checkpoint of the JAX package?): the port "
                f"reads its own checkpoints, <dir>/<name>.pt, and reference .pth / .pth.tar "
                f"files")
        raise FileNotFoundError(f"no checkpoint {stem}.pt")
    states = CheckpointManager(os.path.dirname(os.path.abspath(stem))).restore_model(
        os.path.basename(stem))
    base = states.get("base_model", next(iter(states.values())))
    keep = lambda k: not (drop_aggre and k.startswith("aggre_layer."))
    return {part: {k: v for k, v in base[part].items() if keep(k)}
            for part in ("params", "batch_stats")}
