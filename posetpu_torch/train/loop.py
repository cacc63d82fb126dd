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

    ``place_fn`` (parallel/mesh.shard_host_batch) places the host batch on
    the data mesh before ``prepare``: the loader gives each rank its own
    rows, which it prepares and steps, and the step makes the collectives
    (run/pose2d/train.py:129-225's DDP)."""
    from posetpu_torch.parallel.mesh import local_data
    from posetpu_torch.utils.checks import check_finite_metrics
    from posetpu_torch.utils.profiling import StepTimer

    loader.set_epoch(epoch)
    meters: dict[str, AverageMeter] = {}
    timer = timer if timer is not None else StepTimer()
    nviews = 4
    for i, host_batch in enumerate(loader):
        timer.data_ready()
        batch = prepare(place_fn(host_batch) if place_fn else host_batch)
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
                # this process's rows, paired with as many host rows
                imgs, tgt = (local_data(batch[k])[:, v0] for k in ("images", "target"))
                jc, jv = (np.asarray(host_batch[k])[:len(imgs), v0]
                          for k in ("joints_crop", "joints_vis"))
                save_debug_images(cfg, imgs, jc, jv, jc, tgt, tgt,
                                  os.path.join(debug_dir, f"train_view1_{i:08d}"))
        else:
            timer.step_done()
    return state


def validate(cfg, loader: GroupLoader, dataset, eval_step, variables,
             output_dir: str | None = None, logger=None, place_fn=None, device=None,
             mesh=None):
    """A full validation pass: the eval step a batch, the host accumulation
    in the reference's ``k::nviews`` interleaved layout, the H5 dump of the
    union joints (where ``output_dir`` is given: it needs h5py), then
    ``dataset.evaluate`` (function.py:529-690). ``variables`` is what
    ``eval_step`` takes: the model (``state.params``). Returns (perf,
    name_values, preds [N*V, J, 3], heatmaps [N*V, J, h, w]).

    Over a data mesh each rank takes its rows of every batch of the
    (unsharded) set, in lockstep so that the collectives line up: the
    loader yields them (``GroupLoader(part=(rank, world))``) or
    ``place_fn`` (parallel/mesh.global_batch_from_full_host) cuts them from
    the whole batch; the eval step (made with the same ``mesh``) gathers
    the outputs. Only rank 0 logs, writes the H5 dump and runs
    ``dataset.evaluate``, whose numbers the others receive
    (run/pose2d/train.py:361-391's rank-0 accumulation). The batches go to
    ``device`` (CUDA unless given)."""
    from posetpu_torch.parallel.mesh import broadcast_object, is_primary as primary

    nviews = 4
    is_primary = primary(mesh)
    prepare = make_prepare_fn(cfg, device)
    loss_meter = AverageMeter()
    acc_meter = AverageMeter()
    all_preds: list[np.ndarray] = []
    all_heatmaps: list[np.ndarray] = []

    parted = getattr(loader, "part", (0, 1))[1] > 1  # each rank loads its rows
    for b, host_batch in enumerate(loader):
        n = loader.batch_rows(b) if parted else host_batch["images"].shape[0]
        if place_fn is not None and n < loader.batch_size:
            # the ragged last batch padded to the batch size, so it splits
            # over the ranks; the padded rows wrap around and are cut below
            host_batch = _pad_host_batch(host_batch, loader.batch_size)
        out = eval_step(variables, eval_prepare(cfg, host_batch, place_fn, prepare=prepare))
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
    result = [None]
    if is_primary:
        result[0] = dataset.evaluate(all_preds[:, u, :], preds_dir)
    if mesh is not None:  # the others take rank 0's numbers
        broadcast_object(result, mesh)
    name_values, perf = result[0]
    if is_primary and logger:
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


def eval_prepare(cfg, host_batch, place_fn=None, device=None, prepare=None):
    """One host batch prepared for the eval step on ``device``, placed on
    the data mesh first by ``place_fn`` where given. ``prepare``: a
    data/prepare.make_prepare_fn to reuse."""
    prepare = prepare or make_prepare_fn(cfg, device)
    return prepare(place_fn(host_batch) if place_fn else host_batch)
