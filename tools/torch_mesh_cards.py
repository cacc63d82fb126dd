"""Path 12 over the cards of one host of four H100s: the data mesh at W = 2
and W = 4, held against the plain steps, and timed.

    python3 tools/torch_mesh_cards.py [cli] [hold] [timed] [--out mesh_cards.json]

runs the phases named (all of them by default):

0. (cli) 12b and 12g as ``chip_smoke.py`` runs them on one card
   (``CUDA_VISIBLE_DEVICES=0`` for the commands): the first loss of the
   train command's plain steps equal to 12b's.
1. (cli) The train and validate CLIs as one command each with no process flags,
   on cards 0,1 (``CUDA_VISIBLE_DEVICES``) and then on all four:
   ``chip_smoke.path12g`` (one f32 step of 32 groups, TF32 off, held
   against the plain step on the host batch by ``chip_smoke.hold_mesh_step``;
   the validate CLI's perf against the plain evaluation's).
2. (hold) 12a and 12d over W = 2 and 4 ranks (``cli/common.launch``, one per card,
   NCCL): the supervised step at path 7's configuration and the
   adversarial step at path 8's, both parities with the same draws, in f32
   with TF32 off on 8 groups, each rank its rows; rank 0's loss,
   gradients, parameters and buffers held against the plain step and its
   nudges on card 0 (``hold_mesh_step``).
3. (timed) Path 7's bf16 step at a fixed global batch of 32 groups at W = 1 (the
   plain step), 2 and 4: CUDA events, median and min-max of 10 steps after
   3 warm-ups, the collectives a step, peak memory; then, at W > 1, the
   heads' all-gathers of one step (their shapes recorded in that step) and
   the gradient's all-reduce, each alone (median of 10 after 3 warm-ups).

Each line carries the cards' name and power limit. Exits 1 on a failed
hold or command.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WARMUP, STEPS, REPS = 3, 10, 10


def events_ms(fn, warmup: int, reps: int) -> list:
    """``fn()`` timed with CUDA events after ``warmup`` calls, each call."""
    import torch

    for _ in range(warmup):
        fn()
    ev = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def spread(ms: list) -> dict:
    return {"ms_median": statistics.median(ms), "ms_min": min(ms), "ms_max": max(ms)}


def _cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def hold_rank(layout, kind: str, parity):
    """One rank of a 12a (``kind`` "12a") or 12d hold: its rows of the
    global batch through the step over the mesh; rank 0 returns the step
    (:func:`chip_smoke._one_step`, on the CPU) and the batch's checksum."""
    import torch
    import torch.distributed as dist

    from posetpu_torch.core.mi import sample_draws
    from posetpu_torch.parallel import mesh as pm

    mesh = pm.join(layout, "cuda")
    try:
        dev = mesh.device
        if kind == "12a":
            cfg = cs.train_config(50, 256, 64)
            batch = cs.train_batch(cs.MESH_GROUPS, 256, 64, 16, dev, seed=12)
            make, draws = functools.partial(cs.supervised_states, dev=dev), None
        else:
            cfg = cs.gan_config(50, 256, 64)
            batch = cs.gan_batch(cs.GAN_GROUPS, 256, 64, 16, dev, seed=13)
            make = functools.partial(cs.adversarial_states, dev=dev)
            draws = sample_draws(batch, cfg, parity, torch.Generator(device=dev).manual_seed(14))
        run = cs._one_step(cfg, make, pm.shard_batch(batch, mesh), mesh, 1.0, parity, draws)
        checksum = float(batch["images"].double().sum())
        return (_cpu(run), checksum) if mesh.rank == 0 else None
    finally:
        dist.destroy_process_group()


def hold(world: int, kind: str, parity, dev, card: str) -> tuple[dict, list]:
    """12a or 12d (``parity``) over ``world`` ranks against the plain step
    and its nudges in this process on ``dev``."""
    import torch

    from posetpu_torch.cli.common import launch
    from posetpu_torch.core.mi import sample_draws
    from posetpu_torch.parallel.mesh import Layout

    t = time.perf_counter()
    mesh_run, checksum = launch(hold_rank, Layout(local_ranks=world), kind, parity,
                                collect=True)
    if kind == "12a":
        cfg = cs.train_config(50, 256, 64)
        batch = cs.train_batch(cs.MESH_GROUPS, 256, 64, 16, dev, seed=12)
        make, draws, floor = functools.partial(cs.supervised_states, dev=dev), None, 1e-6
    else:
        cfg = cs.gan_config(50, 256, 64)
        batch = cs.gan_batch(cs.GAN_GROUPS, 256, 64, 16, dev, seed=13)
        make, floor = functools.partial(cs.adversarial_states, dev=dev), 1e-4
        draws = sample_draws(batch, cfg, parity, torch.Generator(device=dev).manual_seed(14))
    runs = {k: cs._one_step(cfg, make, batch, None, f, parity, draws)
            for k, f in (("plain", 1.0), ("nudge +", 1 + 1e-7), ("nudge -", 1 - 1e-7))}
    runs["mesh"] = (mesh_run[0], *({n: {k: v.to(dev) for k, v in d.items()}
                                    for n, d in tree.items()} for tree in mesh_run[1:]))
    label = f"{kind} W={world}" + ("" if parity is None else f" parity {parity}")
    line, failures = cs.hold_mesh_step(label, runs, float(cfg.TRAIN.LR), loss_floor=floor)
    if checksum != float(batch["images"].double().sum()):
        failures.append(f"{label}: the ranks' batch is not this process's")
    line.update(world=world, seconds=time.perf_counter() - t, card=card)
    del runs
    torch.cuda.empty_cache()
    return line, failures


def time_rank(layout):
    """One rank of path 7's bf16 step at GROUPS groups over ``layout``'s
    world (W = 1: the plain step): the step's CUDA-event times, then at W >
    1 the heads' all-gathers of one step and the gradient's all-reduce,
    each alone. Rank 0 returns its numbers."""
    import torch
    import torch.distributed as dist

    from posetpu_torch.parallel import mesh as pm

    group = pm.join(layout, "cuda")
    try:
        dev = torch.device("cuda", layout.local)
        mesh = pm.use_mesh(group)
        cfg = cs.train_config(50, 256, 64)
        states, step = cs.supervised_states(cfg, mesh, dev, dtype=torch.bfloat16)
        st = states["base_model"]
        batch = cs.train_batch(cs.GROUPS, 256, 64, 16, dev, seed=7)
        rows = batch if mesh is None else pm.shard_batch(batch, mesh)
        box = {"st": st}
        losses = []

        def one():
            box["st"], m = step(box["st"], rows)
            losses.append(m["loss"])

        torch.cuda.reset_peak_memory_stats(dev)
        ms = events_ms(one, WARMUP, STEPS)
        out = {"world": layout.world, "groups": cs.GROUPS, "groups_a_rank": len(rows["images"]),
               **spread(ms), "groups_per_s": cs.GROUPS / (statistics.median(ms) / 1e3),
               "losses_finite": bool(torch.isfinite(torch.stack(losses)).all()),
               "first_loss": float(losses[0]),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if mesh is not None:
            shapes, gather = [], pm._all_gather

            def recording(x, m):
                shapes.append((tuple(x.shape), x.dtype))
                return gather(x, m)

            pm.reset_collective_count()
            pm._all_gather = recording
            try:
                one()
            finally:
                pm._all_gather = gather
            out["collectives_a_step"] = pm.collective_count()
            gathers = []
            for shape, dtype in shapes:
                x = torch.ones(shape, dtype=dtype, device=dev)
                gathers.append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                                "out_mb": x.numel() * x.element_size() * mesh.size / 1e6,
                                **spread(events_ms(lambda x=x: gather(x, mesh), WARMUP, REPS))})
            grads = [p.grad for p in box["st"].params.parameters() if p.grad is not None]
            reduce_ms = events_ms(lambda: pm.all_reduce_grads(box["st"].params, mesh),
                                  WARMUP, REPS)
            mb = sum(g.numel() * g.element_size() for g in grads) / 1e6
            out.update(gathers=gathers,
                       gathers_ms_median_sum=sum(g["ms_median"] for g in gathers),
                       gradient_all_reduce={"mb": mb, "buffers": len({g.dtype for g in grads}),
                                            **spread(reduce_ms)})
        return out if layout.rank == 0 else None
    finally:
        if group is not None:
            dist.destroy_process_group()


def guarded(failures: list, label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, or None with the failure (its traceback, or the
    check that stopped it) appended to ``failures``, so that one phase's
    fault does not cost the others' numbers."""
    import traceback

    try:
        return fn(*args, **kw)
    except (Exception, SystemExit):  # noqa: BLE001 - reported, and the run exits 1
        failures.append(f"{label}: {traceback.format_exc(limit=4)}")
        cs.log(failures[-1])
        return None


def main() -> int:
    import torch

    from posetpu_torch.cli.common import launch
    from posetpu_torch.ops import _build
    from posetpu_torch.ops import decode as dec
    from posetpu_torch.parallel.mesh import Layout

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("phases", nargs="*", choices=["cli", "hold", "timed"], default=None)
    p.add_argument("--out", default="mesh_cards.json", help="the JSON of every line")
    args = p.parse_args()
    args.phases = args.phases or ["cli", "hold", "timed"]
    cs.check(torch.cuda.device_count() >= 4, f"{torch.cuda.device_count()} cards: this "
             f"measures W = 2 and 4 on one host of four")
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    cs.log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
           f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build.build(["decode"])  # B7, which the validate CLI launches, once for every rank
    lines, failures = {"card": card}, []
    tmp = tempfile.mkdtemp(prefix="posetpu-mesh-cards-")
    try:
        if "cli" in args.phases:
            t = time.perf_counter()
            logger, said = logging.getLogger("torch_mesh_cards"), []
            logger.propagate = False
            logger.setLevel(logging.INFO)
            handler = logging.Handler()
            handler.emit = lambda record: said.append(record.getMessage())
            logger.addHandler(handler)

            def reset_counts():
                dec.decode_heatmaps_kernel.launches = 0

            def read_counts():
                return {"decode_heatmaps_kernel": dec.decode_heatmaps_kernel.launches}

            guarded(failures, "12b + 12g on card 0", cs.path12_train_cli, tmp, dev, reset_counts,
                    read_counts, logger, said, card, env={"CUDA_VISIBLE_DEVICES": "0"})
            lines["12b + 12g on card 0"] = {"seconds": time.perf_counter() - t}
            data = os.path.join(tmp, "cli12")  # path12_train_cli wrote it
            for world, visible in ((2, "0,1"), (4, "0,1,2,3")):
                t = time.perf_counter()
                line, f = guarded(failures, f"12g W={world}", cs.path12g, tmp, data, dev,
                                  float("nan"), env={"CUDA_VISIBLE_DEVICES": visible},
                                  tag=f"cli_w{world}") or ({}, [])
                line["seconds"] = time.perf_counter() - t
                lines[f"cli W={world}"] = line
                failures += f
                cs.log(f"12g W={world}: " + json.dumps(line) + f" | {card}")
        for world in (2, 4) if "hold" in args.phases else ():
            for kind, parity in (("12a", None), ("12d", 0), ("12d", 1)):
                key = f"{kind} W={world}" + ("" if parity is None else f" parity {parity}")
                line, f = guarded(failures, key, hold, world, kind, parity, dev, card) or ({}, [])
                lines[key] = line
                failures += f
                cs.log(f"{key}: " + json.dumps(line) + f" | {card}")
        for world in (1, 2, 4) if "timed" in args.phases else ():
            line = guarded(failures, f"timed W={world}", launch, time_rank,
                           Layout(local_ranks=world), collect=True) or {"losses_finite": None}
            torch.cuda.empty_cache()
            if line["losses_finite"] is False:
                failures.append(f"timed W={world}: a non-finite loss")
            lines[f"timed W={world}"] = line
            cs.log(f"path 7's bf16 step, 32 groups, W={world}: " + json.dumps(line) + f" | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({**lines, "failures": failures}, indent=1))
    print(card)
    print(json.dumps({"ok": not failures, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
