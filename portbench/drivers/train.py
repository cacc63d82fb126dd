"""The training driver: the program's supervised step
(``posetpu_torch.train.step.make_train_step``) in its configuration's
precision (bf16 compute, f32 parameters and Adam state), chained through
one ``TrainState`` for every step of set-up and of the window.

Set-up builds the state and the step once, from the seed, and drives them
through the first three steps on three different batches of the pool; the
window takes the same objects on, a batch of the pool a step, and ends in
a synchronize.

``correct``: once the window has closed and the program is freed, the
plain reference (f32, TF32 off) follows the first three steps from the
same weights and batches. Read: each of the three losses (relative
gap); the first gradient as Adam's state holds it after step 1 (its first
moment over 1 - b1), by the worst leaf, the worst leaf of two or more
dimensions and the median leaf; the parameters' change over the
three steps, by the worst leaf and by the median leaf; the BatchNorm
running averages after them, by the worst and the median leaf, and
after the first step, by the median leaf. A leaf's gap is the
distance between the program's norm and the reference's, over the larger
of the reference's norm and the median leaf's; a running average's gap is
the norm of its difference from the reference's over the larger of the
reference's change of it and the median change. Leaves whose reference
gradient is under a thousandth of the median leaf's take no part in the
gradient's and the change's gaps. The cell's ``limits`` name the numbers
compared; the others are printed among the counters. The first step's
heatmaps (raw, and fused where the model fuses) are held by the norm of
their difference from the reference's over its norm, for the worst group
and view (``heatmap_gap``) and over the batch.
"""

from __future__ import annotations

import time

from portbench import faults, harness, traffic, weights
from portbench.trace import span, traced

SETUP_STEPS = 3


def run(ctx: harness.Context) -> harness.Record:
    import torch

    from posetpu_torch.models.multiview import get_multiview_pose_net
    from posetpu_torch.train.optim import Optimizer, make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    rec = harness.Record(kind="train", cfg=cfg, cell=cell)
    parts = rec.setup_parts
    t = time.perf_counter()
    pcfg = harness.program_config(cfg)
    batches = traffic.train_pool(cell, cfg, ctx.seed, dev)
    harness.sync(dev)
    parts["traffic_s"] = time.perf_counter() - t

    t = time.perf_counter()
    wts, head_scale = weights.make(cfg, ctx.seed, dev, _probe(batches), train=True)
    dtype = getattr(torch, cell["dtype"])
    with torch.device(dev):
        model = get_multiview_pose_net(pcfg, dtype=dtype)
    harness.load_weights(model, wts)
    del wts
    tx = make_optimizer(pcfg, steps_per_epoch=cell["steps_per_epoch"])
    state = init_train_state(model, tx, device=dev)
    step = make_train_step(model, pcfg, tx, device=dev)
    if ctx.fault:
        step = faults.train_step(ctx.fault, step, tx, model)
    harness.sync(dev)
    parts["model_optimizer_s"] = time.perf_counter() - t

    # the first steps, which the reference follows; they warm up every shape
    t = time.perf_counter()
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().clone() for _, p in model.named_parameters()]
    losses, maps1 = [], []
    hook = model.register_forward_hook(
        lambda mod, args, out: maps1.extend(t.detach().float() for t in out[:2] if t is not None))
    for i in range(SETUP_STEPS):
        state, m = step(state, batches[i])
        losses.append(m["loss"])
        if i == 0:
            hook.remove()
            stats1 = _running_averages(model)
            mu = state.opt_state["mu"]
            grad1 = torch.stack(torch._foreach_norm([mu[n].float() for n in names]))
            grad1 = grad1 / (1.0 - Optimizer.B1)
    params = [p.detach() for _, p in model.named_parameters()]
    change = torch.stack(torch._foreach_norm(torch._foreach_sub(params, p0)))
    del p0, params
    program = {"losses": [float(x) for x in losses], "names": names, "maps1": maps1,
               "grad1": grad1.cpu(), "change": change.cpu(), "stats1": stats1,
               "stats": _running_averages(model)}
    harness.sync(dev)
    parts["first_steps_s"] = time.perf_counter() - t

    # ------------------------------------------------------------ the window
    harness.reset_peak(dev)
    rec.setup_s = time.perf_counter() - ctx.t_start
    losses = []
    k = SETUP_STEPS
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        state, m = step(state, batches[k % len(batches)])
        losses.append(m["loss"])
        k += 1
    harness.sync(dev)
    rec.window_s = time.perf_counter() - t0
    rec.attempted = rec.iterations = len(losses)
    finite = torch.isfinite(torch.stack(losses)) if losses else torch.ones(0, dtype=torch.bool)
    rec.failed = int((~finite).sum())
    rec.groups = cell["groups"] * (rec.attempted - rec.failed)

    if ctx.trace:
        with traced(cell["trace_steps"], dev) as t:
            for j in range(cell["trace_steps"] + 1):
                with span("step"):
                    state, m = step(state, batches[(k + j) % len(batches)])
                t.tick()
        rec.trace = t.trace
    rec.memory_peak_bytes = harness.peak(dev)
    del state, step, model, tx, m
    harness.free(dev)

    _compare(ctx, rec, batches[:SETUP_STEPS], head_scale, program)
    return rec


def control(ctx: harness.Context) -> harness.Record:
    """The cell's control: the plain reference put in the program's place
    and computed in the cell's ``control`` precision (``fp8_e4m3``: every
    tensor the reference's ``cast`` reaches rounded to float8 e4m3 with one
    scale a tensor), over the same first steps; held against the reference
    as a run of the program is. No window."""
    import torch

    from portbench.reference import model as M
    from portbench.reference import train as T

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    if cell["control"]["precision"] != "fp8_e4m3":
        raise ValueError(f"unknown control precision {cell['control']['precision']!r}")
    rec = harness.Record(kind="train", cfg=cfg, cell=cell, attempted=SETUP_STEPS)
    batches = traffic.train_pool(cell, cfg, ctx.seed, dev)[:SETUP_STEPS]
    wts, head_scale = weights.make(cfg, ctx.seed, dev, _probe(batches), train=True)
    with M.full_f32():
        low = T.follow(wts, batches, cfg, cfg["lr"], cast=M.fp8_cast,
                       checkpoint=cell["reference_checkpoint"])
    names = list(low["grad1"])
    program = {"losses": low["losses"], "names": names, "maps1": low["maps1"],
               "stats1": low["stats1"],
               "grad1": torch.stack([low["grad1"][n].norm() for n in names]).cpu(),
               "change": torch.stack([(low["params"][n] - wts[n]).norm() for n in names]).cpu(),
               "stats": low["stats"]}
    del low, wts
    harness.free(dev)
    _compare(ctx, rec, batches, head_scale, program)
    return rec


def _probe(batches):
    """The head rescale's probe: the first two groups of the first batch."""
    return batches[0]["images"][:2].flatten(0, 1)


def _leaf_gaps(prog, ref, floor):
    """|prog - ref| / max(ref, floor) a leaf, prog and ref norms."""
    import torch

    return (prog - ref).abs() / torch.clamp(ref, min=floor)


def _running_averages(model) -> dict:
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _stats_gaps(prog, ref, init, names):
    """A running average's gap a leaf: the norm of the program's difference
    from the reference's over the larger of the reference's change of it
    and the median change."""
    import torch

    moved = torch.stack([(ref[n] - init[n]).norm() for n in names]).cpu()
    diff = torch.stack([(prog[n] - ref[n]).norm() for n in names]).cpu()
    return diff / torch.clamp(moved, min=float(moved.median()))


def _map_gaps(prog, ref):
    """The first step's heatmaps against the reference's: for each kind
    (raw, fused) the norm of the difference over the reference's norm, by
    group and view; inf where the program gave none or of another shape
    (rows left out)."""
    import torch

    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return torch.tensor([float("inf")])
    norm = torch.linalg.vector_norm
    return torch.stack([(norm(p - r, dim=(2, 3, 4)) / norm(r, dim=(2, 3, 4)).clamp(min=1e-12))
                        .max().cpu() for p, r in zip(prog, ref)])


def _compare(ctx, rec, batches, head_scale, program) -> None:
    import torch

    from portbench.reference import model as M
    from portbench.reference import train as T

    cell, cfg, dev = ctx.cell, ctx.cfg, ctx.device
    wts, _ = weights.make(cfg, ctx.seed, dev, head_scale=head_scale)
    with M.full_f32():
        ref = T.follow(wts, batches, cfg, cfg["lr"], checkpoint=cell["reference_checkpoint"])
    names = program["names"]
    r_grad = torch.stack([ref["grad1"][n].norm() for n in names]).cpu()
    r_change = torch.stack([(ref["params"][n] - wts[n]).norm() for n in names]).cpu()
    keep = r_grad >= 1e-3 * r_grad.median()
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"])]
    grad = _leaf_gaps(program["grad1"][keep], r_grad[keep], float(r_grad[keep].median()))
    step = _leaf_gaps(program["change"][keep], r_change[keep], float(r_change[keep].median()))
    s_names = sorted(ref["stats"])
    stats = _stats_gaps(program["stats"], ref["stats"], wts, s_names)
    stats1 = _stats_gaps(program["stats1"], ref["stats1"], wts, s_names)
    kernel = torch.tensor([ref["grad1"][n].dim() >= 2 for n in kept])
    maps = _map_gaps(program["maps1"], ref["maps1"])
    got = {"loss_gap": max(loss), "loss1_gap": loss[0], "grad_gap": float(grad.max()),
           "grad_gap_median": float(grad.median()), "step_gap": float(step.max()),
           "step_gap_median": float(step.median()), "stats_gap": float(stats.max()),
           "stats_gap_median": float(stats.median()),
           "grad_gap_kernels": float(grad[kernel].max()),
           "stats1_gap_median": float(stats1.median()), "heatmap_gap": float(maps.max())}
    limits = cell["limits"]
    rec.compared = {k: (v, limits[k]) for k, v in got.items() if k in limits}
    rec.counters = {"leaves": len(names), "leaves_left_out": int((~keep).sum()),
                    "losses": program["losses"], "reference_losses": ref["losses"],
                    "worst_grad_leaf": kept[int(grad.argmax())],
                    "worst_step_leaf": kept[int(step.argmax())],
                    "worst_stats_leaf": s_names[int(stats.argmax())],
                    **{k: v for k, v in got.items() if k not in limits}}
    rec.correct = rec.failed == 0 and rec.attempted > 0 and all(
        v <= lim for v, lim in rec.compared.values())
