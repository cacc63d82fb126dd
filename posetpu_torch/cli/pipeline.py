"""The self-training loop (train.sh:86-109) run from one Python module.

Each iteration: (1) train on MPII [+ the current pseudo labels], (2) infer
over the unlabelled H36M training set and dump the heatmap H5, (3) mint
pseudo labels (threshold + RANSAC + the optional reprojection), (4) hand
them to the next iteration's mixed training. ``--repeats`` sets the number
of iterations; ``--fund`` adds the epipolar loss from iteration 1 on, as
the reference's ``-f`` flag does.

    python -m posetpu_torch.cli.pipeline --cfg <yaml> [--repeats 2] [--fund] \\
        [--ransac] [--use-reproj] [--adaptive-thre] [--fresh] [--epochs N]

The stages hand off through H5 files, so the loop needs h5py. They run on
CUDA unless the caller passes ``device="cpu"``; the train stage on every
GPU of the host, as the train CLI (cli/common.launch).
"""

from __future__ import annotations

import os


def parse_args(argv=None):
    from posetpu_torch.cli.common import base_parser

    p = base_parser("Self-training loop")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--ransac", action="store_true")
    p.add_argument("--inliers", type=int, default=3)
    p.add_argument("--reproj-thre", type=float, default=10.0)
    p.add_argument("--confidence-thre", type=float, default=0.7)
    p.add_argument("--use-reproj", action="store_true")
    p.add_argument("--fund", action="store_true", help="epipolar loss from iteration 1")
    p.add_argument("--no-distortion", action="store_true")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--fresh", action="store_true",
                   help="ignore any saved pipeline state and restart from iteration 0")
    p.add_argument("--adaptive-thre", action="store_true",
                   help="sweep confidence thresholds each iteration and pick from the "
                        "Pareto front (instead of the fixed --confidence-thre)")
    return p.parse_args(argv)


def default_stage_fns(args, log=print, device=None):
    """The stages in this process, as train.sh runs its scripts (train ->
    valid_trainset -> test_pseudo_label): ``train_fn(cfg, pseudo_path, it)
    -> (TrainState, output dir)``, ``validate_fn(cfg, that, it) -> H5
    path``, ``mint_fn(cfg, h5 path, it) -> pseudo-label H5 path``."""
    import numpy as np

    from posetpu_torch import resolve_device

    dev = resolve_device(device)

    def train_fn(cfg, pseudo_path, it):
        from posetpu_torch.cli.common import build_model, launch
        from posetpu_torch.parallel.mesh import host_layout
        from posetpu_torch.train.checkpoint import CheckpointManager
        from posetpu_torch.train.state import TrainState

        # one rank per GPU in use, as the train CLI (cli/common.launch)
        layout = host_layout(device=dev)
        if layout.local_ranks == 1:
            return _train_stage(layout, cfg, args, pseudo_path, it, dev)
        output_dir = launch(_train_stage, layout, cfg, args, pseudo_path, it, dev, collect=True)
        # the ranks' final_state, read back for the validate stage
        model = build_model(cfg, bf16=False)
        saved = CheckpointManager(output_dir).restore_model("final_state")["base_model"]
        model.load_state_dict({**saved["params"], **saved["batch_stats"]})
        return TrainState(model.to(dev), None, 0), output_dir

    def validate_fn(cfg, state_and_dir, it):
        from posetpu_torch.data.loader import GroupLoader
        from posetpu_torch.data.registry import get_dataset
        from posetpu_torch.train.loop import validate
        from posetpu_torch.train.step import make_eval_step

        state, output_dir = state_and_dir
        # is_train=True keeps the ::5 training grouping the pseudo-label
        # stage reads (valid_trainset.py builds the data set so)
        ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, "train", True,
                                                   no_distortion=args.no_distortion)
        loader = GroupLoader(ds, cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
                             num_threads=int(cfg.WORKERS))
        eval_step = make_eval_step(state.params, cfg, flip_pairs=ds.flip_pairs, device=dev)
        validate(cfg, loader, ds, eval_step, state.params, output_dir=output_dir, device=dev)
        return os.path.join(output_dir, f"heatmaps_locations_train_{ds.dataset_type}.h5")

    def mint_fn(cfg, heatmap_path, it):
        from posetpu_torch.data.base import sorted_union_indices
        from posetpu_torch.data.h5io import load_heatmaps
        from posetpu_torch.data.registry import get_dataset
        from posetpu_torch.pseudo.labeler import mint_pseudo_labels

        ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, "train", True,
                                                   no_distortion=args.no_distortion)
        _, locations, _ = load_heatmaps(heatmap_path)
        out_dir = os.path.join(os.path.dirname(heatmap_path), f"pseudo_it{it}")
        u = sorted_union_indices(ds.u2a_mapping)
        gt2d = ds.gt_joints_flat()[0][:, u]
        flat = [i for g in ds.grouping for i in g]
        scales = np.array([ds.db[i]["scale"] for i in flat])
        adaptive = getattr(args, "adaptive_thre", False)
        summary = mint_pseudo_labels(
            locations[:, :, :2], locations[:, :, 2], ds.cameras_flat(), out_dir,
            gt2d=gt2d, headsizes=np.amax(scales, 1, keepdims=True) * 20,
            loop=not adaptive, confidence_thre=args.confidence_thre,
            thresholds=(0.1, 0.3, 0.5, 0.7, 0.9), if_ransac=args.ransac,
            num_inliers=args.inliers, reproj_thre=args.reproj_thre, use_reproj=True,
            no_distortion=args.no_distortion, log=log, device=dev)
        if adaptive:
            # the sweep ran (the reference's select.txt regime): pick from
            # its Pareto front, so that a detector whose peak confidence
            # drifts between iterations does not strand the loop on a
            # fixed threshold
            name = summary["choose"]()
            log(f"=> adaptive threshold picked {name}")
            return os.path.join(out_dir, f"{name}_pseudo_label.h5")
        return os.path.join(out_dir, f"{args.confidence_thre}_1_pseudo_label.h5")

    return train_fn, validate_fn, mint_fn


def _train_stage(layout, cfg, args, pseudo_path, it, device):
    """The train stage on one rank (parallel/mesh.Layout): MPII [+ the
    pseudo labels] for ``--epochs`` epochs over the host's ranks (each its
    rows of the batch, the steps over the data mesh where there are two or
    more), warm-started from the previous iteration's final_state; rank 0
    logs and writes the new one. Returns (the TrainState, the output
    directory) in this process where the host runs one rank, else the
    output directory."""
    import torch
    import torch.distributed as dist

    from posetpu_torch import resolve_device
    from posetpu_torch.cli.common import build_model
    from posetpu_torch.cli.train import build_fund_extra
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.parallel.mesh import is_primary, join, shard_host_batch, use_mesh
    from posetpu_torch.train.checkpoint import CheckpointManager
    from posetpu_torch.train.loop import train_epoch
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_train_step
    from posetpu_torch.utils.logging import create_logger

    group = join(layout, device)
    try:
        mesh = use_mesh(group)
        dev = resolve_device(device) if group is None else group.device
        logger, output_dir, _ = create_logger(cfg, args.cfg, f"pipeline_it{it}")
        train_ds = get_dataset(cfg.DATASET.TRAIN_DATASET)(
            cfg, cfg.DATASET.TRAIN_SUBSET, True, pseudo_label_path=pseudo_path,
            no_distortion=args.no_distortion)
        loader = GroupLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=True,
                             num_threads=max(1, int(cfg.WORKERS) // layout.local_ranks),
                             part=(layout.local, layout.local_ranks))
        if cfg.DATASET.IF_SAMPLE and hasattr(train_ds, "group_weights"):
            # source-balanced sampling (as cli/train.py): at iteration 0
            # every h36m group has zero supervision weight, so an unbalanced
            # mixed epoch wastes most of its steps
            loader.set_weights(train_ds.group_weights(cfg))
        model = build_model(cfg, bf16=False,
                            generator=torch.Generator().manual_seed(int(cfg.SEED)))
        tx = make_optimizer(cfg, steps_per_epoch=max(len(loader), 1))
        step = make_train_step(model, cfg, tx, mesh=mesh, device=dev)
        prepare = make_prepare_fn(cfg, dev)
        state = init_train_state(model, tx, device=dev)
        ckpt = CheckpointManager(output_dir, mesh=mesh)
        if it > 0 and ckpt.exists("final_state"):
            # the warm start from the previous iteration's model: the
            # reference's pseudo configs set TRAIN.RESUME with RESUME_PATH
            # at the previous final_state (train.sh:86-109), the model
            # alone with a fresh optimizer (run/pose2d/train.py:250-275)
            prev = ckpt.restore_model("final_state")["base_model"]
            state.params.load_state_dict({**prev["params"], **prev["batch_stats"]})
            logger.info("=> warm start from the previous iteration's final_state")
        extra = build_fund_extra(cfg, train_ds, dev) if cfg.LOSS.USE_FUNDAMENTAL_LOSS else None
        place = None if mesh is None else (lambda t: shard_host_batch(t, mesh))
        primary = is_primary(mesh)
        for epoch in range(args.epochs or cfg.TRAIN.END_EPOCH):
            state = train_epoch(cfg, loader, prepare, step, state, epoch,
                                logger=logger if primary else None, extra_batch_fn=extra,
                                place_fn=place)
        ckpt.save_final({"base_model": state})
        return (state, output_dir) if layout.local_ranks == 1 else output_dir
    finally:
        if group is not None:
            dist.destroy_process_group()


def pipeline_state_path(cfg, args) -> str:
    """The resume record's path, beside the training output, so that a job
    restarted after a preemption finds it."""
    from posetpu_torch.config import get_model_name

    model_name, _ = get_model_name(cfg)
    cfg_base = os.path.splitext(os.path.basename(getattr(args, "cfg", "") or ""))[0] or "default"
    d = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.TRAIN_DATASET, model_name, cfg_base)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "pipeline_state.json")


def run_pipeline(cfg, args, train_fn=None, validate_fn=None, mint_fn=None, log=print,
                 device=None):
    """One self-training run; returns the last pseudo-label path. The stage
    functions may be given (tests inject them); by default
    :func:`default_stage_fns` on ``device``.

    After each finished iteration the (next iteration, pseudo-label path)
    pair is saved; a restarted run skips the finished iterations (the
    reference's cluster resume, run/pose2d/train.py:277-286, which keeps the
    iteration in the checkpoint). ``--fresh`` forgets the record."""
    import json

    from posetpu_torch.config import clone

    if train_fn is None:
        train_fn, validate_fn, mint_fn = default_stage_fns(args, log=log, device=device)

    state_file = pipeline_state_path(cfg, args)
    start_it, pseudo_path = 0, ""
    if getattr(args, "fresh", False):
        if os.path.exists(state_file):
            os.remove(state_file)
    elif os.path.exists(state_file):
        with open(state_file) as f:
            saved = json.load(f)
        start_it = int(saved.get("next_iteration", 0))
        pseudo_path = saved.get("pseudo_path", "")
        if start_it > 0:
            log(f"=> pipeline resume: iterations 0..{start_it - 1} already complete, "
                f"continuing at iteration {start_it}")

    for it in range(start_it, args.repeats):
        log(f"==== pipeline iteration {it} ====")
        it_cfg = clone(cfg)
        if args.fund and it >= 1:
            it_cfg.LOSS.USE_FUNDAMENTAL_LOSS = True
        state = train_fn(it_cfg, pseudo_path, it)
        heatmap_path = validate_fn(it_cfg, state, it)
        pseudo_path = mint_fn(it_cfg, heatmap_path, it)
        log(f"iteration {it}: pseudo labels at {pseudo_path}")
        with open(state_file, "w") as f:
            json.dump({"next_iteration": it + 1, "pseudo_path": pseudo_path}, f)
    return pseudo_path


def main(argv=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    return run_pipeline(load_cfg(args), args)


if __name__ == "__main__":
    main()
