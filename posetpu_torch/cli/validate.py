"""Evaluation entry point, run/pose2d/valid.py's equivalent: forward the
TEST (or train) set, dump the heatmap / location H5 interchange file, print
the PCKh table.

    python -m posetpu_torch.cli.validate --cfg <yaml> --state <ckpt> \\
        [--trainset] [--flip-test] [--f32] \\
        [--int8 [--calib-batches N] [--qat-steps N [--qat-lr LR]] \\
                [--int8-act4 l12|<names>] [--int8-subpixel deconv0,...]] \\
        [--coordinator host:port --num-processes H --process-id h]

``--state`` is a reference torch checkpoint (``.pth`` / ``.pth.tar``,
converted on the fly by models/convert_torch.py) or one of the port's own
(``<dir>/<name>[.pt]``: the train CLI's ``final_state``, cli/convert.py's
output). ``--int8`` serves the int8 trunk (train/serve.py), calibrated on the
first ``--calib-batches`` batches and, with ``--qat-steps``, QAT fine-tuned
on them first. ``--trainset`` mirrors run/pose2d/valid_trainset.py:
inference over the training grouping, to mint pseudo labels from.

One command a host evaluates on every GPU it sees, one rank each
(cli/common.launch), as the JAX CLI does over a host's devices: the float
evaluation runs over the data mesh (each rank decodes and steps its rows of
every batch, the outputs gathered; the JAX package's rule: more than one
device and ``TEST.BATCH_SIZE`` a multiple of their count), and rank 0
writes the dump. The process flags keep ``jax.distributed.initialize``'s
meaning, processes are hosts (cli/train.py). The int8 serving runs whole on
each host's first GPU.
"""

from __future__ import annotations


def parse_args(argv=None):
    from posetpu_torch.cli.common import add_process_flags, base_parser

    p = base_parser("Validate multi-view pose network")
    p.add_argument("--state", default="", help="checkpoint path (reference torch or the port's)")
    p.add_argument("--flip-test", action="store_true")
    p.add_argument("--post-process", action="store_true")
    p.add_argument("--shift-heatmap", action="store_true")
    p.add_argument("--trainset", action="store_true",
                   help="run on the training subset (pseudo-label inference)")
    p.add_argument("--no-distortion", action="store_true")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 PTQ trunk (calibrated on the first batches)")
    p.add_argument("--calib-batches", type=int, default=2,
                   help="batches used for int8 activation calibration")
    p.add_argument("--qat-steps", type=int, default=0,
                   help="with --int8: distillation QAT fine-tune steps over "
                        "the eval images before quantizing (repairs the PTQ "
                        "accuracy delta; no labels needed)")
    p.add_argument("--qat-lr", type=float, default=3e-6)
    p.add_argument("--int8-act4", default="",
                   help="with --int8: sub-int8 activation boundaries — "
                        "'l12' (layer1+layer2 block outputs) or a comma-"
                        "separated list of boundary names; stored at 4 bits "
                        "(s4)")
    p.add_argument("--int8-subpixel", default="",
                   help="with --int8: comma-separated deconv names to "
                        "quantize in per-phase subpixel form (finer weight "
                        "scales)")
    add_process_flags(p)
    return p.parse_args(argv)


def act4_names(spec: str) -> tuple:
    """``--int8-act4``: "l12" (the seven layer1 + layer2 block outputs) or
    comma-separated boundary names."""
    if spec == "l12":
        return tuple(f"layer1_{i}.out" for i in range(3)) + tuple(
            f"layer2_{i}.out" for i in range(4))
    return tuple(filter(None, spec.split(",")))


def run(cfg, args, device=None, log=None, dump: bool = True, local_ranks: int | None = None):
    """Validate as ``python -m posetpu_torch.cli.validate`` does: one rank
    per GPU in use on this host (parallel/mesh.host_layout; on the CPU
    ``local_ranks`` gloo ranks, default 1) through cli/common.launch.
    ``log``: a logging.Logger to write to in place of the run's own;
    ``dump``: write the heatmap H5 into the output directory (rank 0 does,
    where h5py is installed). Returns local rank 0's validate loop's (perf,
    name_values, preds [N*V, J, 3], heatmaps [N*V, J, h, w])."""
    from posetpu_torch.cli.common import launch
    from posetpu_torch.parallel.mesh import Layout, host_layout

    layout = host_layout(args.coordinator, args.num_processes, args.process_id, device,
                         local_ranks)
    if args.int8:  # the int8 serving runs whole, one rank on each host's first device
        layout, dump = Layout(), dump and layout.host == 0
    return launch(_rank, layout, cfg, args, device, log, dump, collect=True)


def _rank(layout, cfg, args, device, log, dump):
    """One rank of :func:`run`: it joins the group for the run."""
    import torch.distributed as dist

    from posetpu_torch.parallel.mesh import join

    dump = dump and layout.rank == 0
    mesh = join(layout, device)
    try:
        return _run(cfg, args, device, log, dump, mesh, layout)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(cfg, args, device, log, dump, mesh, layout):
    import torch

    from posetpu_torch import resolve_device
    from posetpu_torch.cli.common import build_model, load_model_variables
    from posetpu_torch.data import h5io
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.parallel.mesh import use_mesh
    from posetpu_torch.train.loop import validate
    from posetpu_torch.train.serve import build_quant_from_variables, make_quant_eval_step
    from posetpu_torch.train.step import make_eval_step
    from posetpu_torch.utils.logging import create_logger

    dev = resolve_device(device) if mesh is None else mesh.device
    # valid.py forces the MI / fundamental losses off at eval (valid.py:133-135)
    cfg.LOSS.USE_FUNDAMENTAL_LOSS = False
    cfg.LOSS.USE_LOCAL_MI_LOSS = False
    cfg.LOSS.USE_GLOBAL_MI_LOSS = False
    if args.flip_test:
        cfg.TEST.FLIP_TEST = True
    if args.post_process:
        cfg.TEST.POST_PROCESS = True
    if args.shift_heatmap:
        cfg.TEST.SHIFT_HEATMAP = True

    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    logger = log or logger
    logger.info(f"rank {layout.rank} of {layout.world} (host {layout.host} of {layout.hosts}): "
                f"{dev}"
                + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    subset = "train" if args.trainset else cfg.DATASET.TEST_SUBSET
    # --trainset keeps is_train=True: valid_trainset.py:155 builds the TRAIN
    # grouping (::5), so the heatmap dump's rows line up with what
    # cli.pseudo_labels and cli.triangulate read
    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, subset, args.trainset,
        no_distortion=args.no_distortion or cfg.DATASET.NO_DISTORTION)
    # the evaluation over the data mesh (valid.py:169-171's DataParallel)
    # where the batch splits evenly over its ranks: each rank loads its rows
    # of every batch; the int8 serving loads them all
    eval_mesh = None if args.int8 else use_mesh(mesh, int(cfg.TEST.BATCH_SIZE))
    loader = GroupLoader(dataset, cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
                         num_threads=max(1, int(cfg.WORKERS) // layout.local_ranks),
                         part=(0, 1) if eval_mesh is None else (eval_mesh.rank, eval_mesh.size))
    logger.info(f"groups: {len(dataset)}")
    state_path = args.state or cfg.TEST.STATE or cfg.TEST.MODEL_FILE
    if not state_path:
        raise ValueError("--state (or TEST.STATE) required")
    variables = load_model_variables(state_path, drop_aggre=not cfg.NETWORK.AGGRE)
    if dump and not h5io.available():
        logger.info("h5py is not installed: no heatmap H5 dump")
    dump_dir = output_dir if dump and h5io.available() else None

    if args.int8:
        prep = make_prepare_fn(cfg, dev)
        calib = []
        it = iter(loader)
        try:
            for host_batch in it:
                imgs = prep(host_batch)["images"]
                calib.append(imgs.reshape((-1,) + imgs.shape[2:]))
                if len(calib) >= max(1, args.calib_batches):
                    break
        finally:
            it.close()
        qat_batches = None
        if args.qat_steps > 0:
            # the calibration images cycled for the requested steps: the
            # distillation needs no labels, only serving-like pixels
            qat_batches = [calib[i % len(calib)] for i in range(args.qat_steps)]
            logger.info(f"=> QAT fine-tune: {args.qat_steps} steps @ lr {args.qat_lr}")
        subpixel = set(filter(None, args.int8_subpixel.split(",")))
        act4 = act4_names(args.int8_act4)
        if act4:
            logger.info(f"=> int4 activation boundaries: {act4}")
            if qat_batches:
                logger.info("=> act4 is not applied under QAT: the QAT trunk serves int8 "
                            "at every boundary")
        qparams, qfwd, bank = build_quant_from_variables(
            cfg, variables, calib, qat_batches=qat_batches, qat_lr=args.qat_lr,
            subpixel_deconvs=subpixel or False, act4=act4, device=dev)
        del calib, qat_batches, variables
        eval_step = make_quant_eval_step(qfwd, cfg, flip_pairs=dataset.flip_pairs,
                                         has_aggre=bank is not None, device=dev)
        logger.info("=> serving the int8 PTQ trunk")
        out = validate(cfg, loader, dataset, eval_step, {"q": qparams, "bank": bank},
                       output_dir=dump_dir, logger=logger, device=dev)
    else:
        model = build_model(cfg, bf16=not args.f32)
        model.load_state_dict({**variables["params"], **variables["batch_stats"]})
        del variables
        model.to(dev)
        eval_step = make_eval_step(model, cfg, flip_pairs=dataset.flip_pairs, mesh=eval_mesh,
                                   device=dev)
        logger.info(f"eval devices: {1 if eval_mesh is None else eval_mesh.size}")
        out = validate(cfg, loader, dataset, eval_step, model, output_dir=dump_dir,
                       logger=logger, device=dev, mesh=eval_mesh)
    if layout.rank == 0:
        logger.info(f"perf indicator: {out[0]:.4f}")
    return out


def main(argv=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    return run(load_cfg(args), args)[0]


if __name__ == "__main__":
    main()
