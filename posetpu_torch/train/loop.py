"""The epoch loop: train_epoch and validate.

Host-side equivalents of train() and validate() (lib/core/function.py:
91-690) around the step functions: one step call a batch; the host
shuffles, prefetches, accumulates the eval arrays and writes the H5 dump.
Between logging steps the host never waits for the card: it only fetches
a metric on a logging step (PRINT_FREQ).
"""

from __future__ import annotations

import os

import numpy as np

from posetpu_torch.data.base import sorted_union_indices
from posetpu_torch.data.h5io import save_heatmaps
from posetpu_torch.data.loader import GroupLoader
from posetpu_torch.data.prepare import make_prepare_fn
from posetpu_torch.utils.logging import AverageMeter


def _no_place(place_fn, where: str) -> None:
    if place_fn is not None:
        raise NotImplementedError(
            f"{where}: place_fn (data parallelism over several devices) is not ported yet "
            f"(ROADMAP A6); pass place_fn=None")


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def train_epoch(cfg, loader: GroupLoader, prepare, train_step, state,
                epoch: int, logger=None, writer=None, extra_batch_fn=None,
                debug_dir: str | None = None, place_fn=None, timer=None):
    """One training epoch; returns the state. ``extra_batch_fn(host_batch,
    device_batch)`` adds per-batch extras (the fundamental matrices by
    subject). With ``debug_dir`` and DEBUG.DEBUG, dumps GT joint and heatmap
    grids every PRINT_FREQ as the reference does (function.py:521-526).
    ``timer`` (a utils/profiling.StepTimer) is the one the loop times its
    steps and data waits with, for a caller that reads it afterwards.
    ``place_fn`` is None only: data parallelism is not ported (A6)."""
    from posetpu_torch.utils.checks import check_finite_metrics
    from posetpu_torch.utils.profiling import StepTimer

    _no_place(place_fn, "train_epoch")
    loader.set_epoch(epoch)
    meters: dict[str, AverageMeter] = {}
    timer = timer if timer is not None else StepTimer()
    nviews = 4
    for i, host_batch in enumerate(loader):
        timer.data_ready()
        batch = prepare(host_batch)
        if extra_batch_fn is not None:
            batch = extra_batch_fn(host_batch, batch)
        state, metrics = train_step(state, batch)
        nimgs = host_batch["images"].shape[0] * nviews
        if logger is not None and i % cfg.PRINT_FREQ == 0:
            # fetching the loss is also the device sync of the step timing
            timer.step_done(metrics["loss"])
            check_finite_metrics(metrics, i)
            parts = []
            for k in sorted(metrics):
                meters.setdefault(k, AverageMeter()).update(float(metrics[k]), nimgs)
                parts.append(f"{k} {meters[k].val:.5f} ({meters[k].avg:.5f})")
            perf = timer.summary(samples_per_step=nimgs)
            speed = perf.get("samples_per_s", 0.0)
            mem = perf.get("bytes_in_use", -1)
            h36m_pct = float(np.mean(host_batch["is_h36m"]))
            src_msg = f"h36m {h36m_pct:.1%} other {1 - h36m_pct:.1%}"
            logger.info(
                f"Epoch [{epoch}][{i}/{len(loader)}] "
                f"Speed {speed:.1f} samples/s\tData {perf.get('data_ms', 0):.1f}ms\t"
                f"Memory {mem}\t" + "\t".join(parts) + "\t" + src_msg
            )
            if writer is not None:
                base = state["base_model"] if isinstance(state, dict) else state
                for k, m in meters.items():
                    writer.add_scalar(f"train_{k}", m.val, int(base.step))
            if debug_dir is not None and cfg.DEBUG.DEBUG:
                from posetpu_torch.utils.vis import save_debug_images

                v0 = 0  # the first view, like the reference's per-view loop
                tgt = batch["target"][:, v0]
                save_debug_images(
                    cfg, batch["images"][:, v0], host_batch["joints_crop"][:, v0],
                    host_batch["joints_vis"][:, v0], host_batch["joints_crop"][:, v0],
                    tgt, tgt, os.path.join(debug_dir, f"train_view1_{i:08d}"))
        else:
            timer.step_done()
    return state


def validate(cfg, loader: GroupLoader, dataset, eval_step, variables,
             output_dir: str | None = None, logger=None, place_fn=None, device=None):
    """A full validation pass: the eval step a batch, the host accumulation
    in the reference's ``k::nviews`` interleaved layout, the H5 dump of the
    union joints (where ``output_dir`` is given: it needs h5py), then
    ``dataset.evaluate`` (function.py:529-690). ``variables`` is what
    ``eval_step`` takes: the model (``state.params``). Returns (perf,
    name_values, preds [N*V, J, 3], heatmaps [N*V, J, h, w]).

    One process does it all (the JAX package's process 0); ``place_fn`` is
    None only (A6). The batches go to ``device`` (CUDA unless given)."""
    _no_place(place_fn, "validate")
    nviews = 4
    is_primary = True
    prepare = make_prepare_fn(cfg, device)
    loss_meter = AverageMeter()
    acc_meter = AverageMeter()
    all_preds: list[np.ndarray] = []
    all_heatmaps: list[np.ndarray] = []

    for host_batch in loader:
        n = host_batch["images"].shape[0]
        out = eval_step(variables, prepare(host_batch))
        nimgs = n * nviews
        loss_meter.update(float(out["loss"]), nimgs)
        acc_meter.update(float(out["acc"]), nimgs)

        preds = _np(out["preds"])[:n]  # [N, V, J, 2]
        maxv = _np(out["maxvals"])[:n][..., None]  # [N, V, J, 1]
        pred3 = np.concatenate([preds, maxv], axis=-1)
        hm = np.moveaxis(_np(out["heatmaps"])[:n], -1, 2)  # [N, V, J, h, w]
        # interleave views like the reference's preds[k::nviews] fill
        all_preds.append(pred3.reshape(nimgs, *pred3.shape[2:]))
        all_heatmaps.append(hm.reshape(nimgs, *hm.shape[2:]))

    all_preds = np.concatenate(all_preds) if all_preds else np.zeros((0, 16, 3))
    all_heatmaps = (np.concatenate(all_heatmaps) if all_heatmaps
                    else np.zeros((0, 16, 4, 4)))

    u = sorted_union_indices(dataset.u2a_mapping)
    if output_dir and is_primary:
        path = os.path.join(
            output_dir, f"heatmaps_locations_{dataset.subset}_{dataset.dataset_type}.h5")
        save_heatmaps(path, all_heatmaps[:, u], all_preds[:, u], u)
        if logger:
            logger.info(f"=> heatmap dump: {path}")

    preds_dir = output_dir if (output_dir and cfg.DEBUG.SAVE_ALL_PREDS and is_primary) else None
    name_values, perf = dataset.evaluate(all_preds[:, u, :], preds_dir)
    if logger and is_primary:
        names = list(name_values.keys())
        logger.info("| Arch " + " ".join(f"| {n}" for n in names) + " |")
        logger.info("|---" * (len(names) + 1) + "|")
        logger.info("| posetpu " + " ".join(f"| {v:.3f}" for v in name_values.values()) + " |")
        logger.info(f"validate: loss {loss_meter.avg:.4f} acc {acc_meter.avg:.3f}")
    return perf, name_values, all_preds, all_heatmaps


def _pad_host_batch(host_batch: dict, to_n: int) -> dict:
    """Every leading axis padded to ``to_n`` rows by wrapping around the
    real rows (callers slice the outputs back to the true count)."""
    n = next(iter(host_batch.values())).shape[0]
    idx = np.arange(to_n) % n
    return {k: np.asarray(v)[idx] for k, v in host_batch.items()}


def eval_prepare(cfg, host_batch, place_fn=None, device=None):
    """One host batch prepared for the eval step on ``device``."""
    _no_place(place_fn, "eval_prepare")
    return make_prepare_fn(cfg, device)(host_batch)
