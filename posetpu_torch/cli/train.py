"""Training entry point: run/pose2d/train.py's equivalent.

    python -m posetpu_torch.cli.train --cfg experiments/mixed/resnet50/...yaml \
        [--pseudo-path X.h5] [--no-distortion] [--epochs N] [--batch N] [--f32] \
        [--coordinator host:port --num-processes H --process-id h]

One command a host trains on every GPU it sees (``CUDA_VISIBLE_DEVICES``
narrows them): it starts one rank per GPU (cli/common.launch), and the
ranks form a data mesh (parallel/mesh.py, NCCL) that steps on the global
batch, as the JAX CLI does over a host's devices. The process flags keep
``jax.distributed.initialize``'s meaning: over H hosts, start the command
once on each with the same ``--coordinator`` and ``--num-processes`` and
its own ``--process-id``. Each host reads its shard of the training set,
``TRAIN.BATCH_SIZE`` groups a step in the order one process draws them,
split over its GPUs (each rank decodes its own rows), so the global batch
is H times that; the learning-rate schedule counts the host loader's
steps. Rank 0 logs and writes the checkpoints. The train state
warm-starts from ``TRAIN.RESUME_PATH`` (one of the port's own checkpoints:
``<output dir>/final_state``) and, with ``TRAIN.ON_SERVER_CLUSTER``,
resumes from the run's last ``checkpoint``. An enabled MI or domain loss
switches to the adversarial step.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import threading
from typing import Any, Callable


def parse_args(argv=None):
    from posetpu_torch.cli.common import add_process_flags, base_parser

    p = base_parser("Train multi-view pose network")
    p.add_argument("--pseudo-path", default="", help="pseudo label h5")
    p.add_argument("--no-distortion", action="store_true")
    p.add_argument("--epochs", type=int, default=0, help="override END_EPOCH")
    p.add_argument("--batch", type=int, default=0, help="override batch size")
    p.add_argument("--f32", action="store_true", help="disable bf16 compute")
    add_process_flags(p)
    return p.parse_args(argv)


def build_fund_extra(cfg, dataset, device=None) -> Callable:
    """``extra(host_batch, device_batch)``: adds ``fmats`` [N, 12, 3, 3], the
    fundamental matrices of each group's subject (a non-h36m group takes the
    first subject's). The bank is the reference's pickle where
    ``<ROOT>/testdata/fundamental_matrix.pkl`` exists, else exact from the
    data set's calibration. On a card the matrices go up from pinned memory
    with ``non_blocking``, so the loop does not wait on the card."""
    from posetpu_torch import resolve_device
    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.fundamental import (
        bank_to_batch,
        build_fundamental_bank,
        load_reference_bank,
    )

    dev = resolve_device(device)
    pkl = os.path.join(cfg.DATASET.ROOT, "testdata", "fundamental_matrix.pkl")
    if os.path.exists(pkl):
        bank = load_reference_bank(pkl)
    else:
        h36m = getattr(dataset, "h36m", dataset)
        cams_by_subject = {}
        for items in h36m.grouping:
            subj = h36m.db[items[0]]["subject"]
            if subj not in cams_by_subject:
                cams_by_subject[subj] = CameraParams.stack(
                    [CameraParams.from_dict(h36m.db[i]["camera"]) for i in items])
        bank = build_fundamental_bank(cams_by_subject)
    default_subj = next(iter(bank))[0]

    def extra(host_batch, device_batch):
        subjects = [s if s >= 0 else default_subj for s in host_batch["subject"]]
        fmats = bank_to_batch(bank, subjects)
        device_batch["fmats"] = (fmats.pin_memory().to(dev, non_blocking=True)
                                 if dev.type == "cuda" else fmats.to(dev))
        return device_batch

    return extra


@dataclasses.dataclass
class Training:
    """What :func:`setup` builds and :func:`train_epochs` runs."""

    cfg: Any
    device: Any
    logger: Any
    output_dir: str
    writer: Any
    train_ds: Any
    test_ds: Any
    train_loader: Any
    test_loader: Any
    prepare: Callable
    eval_step: Callable
    train_step: Callable
    state: Any  # a TrainState, or {"base_model": TrainState, critic: TrainState}
    adversarial: bool
    run_ctx: dict
    ckpt: Any
    begin_epoch: int
    extra: Callable | None
    timer: Any = None  # a utils/profiling.StepTimer the loop times its steps with
    mesh: Any = None  # the steps' parallel/mesh.DataMesh (two or more ranks), or None
    tx: Any = None  # the base model's optimizer (train/optim.Optimizer)

    @property
    def base(self):
        return self.state["base_model"] if self.adversarial else self.state

    def states(self) -> dict:
        """Every component's train state, as the checkpoints hold them."""
        return self.state if self.adversarial else {"base_model": self.state}


def setup(cfg, args, device=None, log=None, layout=None) -> Training:
    """Everything before the epoch loop (posetpu/cli/train.py:71-228) on
    one rank: the logger and output directories, the data sets and loaders
    (with ``IF_SAMPLE``), the model, optimizer, eval step and prepare, the
    train state and the supervised or adversarial step (the samplers seeded
    from ``cfg.SEED``), the warm start from ``TRAIN.RESUME_PATH``, the
    auto-resume (``TRAIN.ON_SERVER_CLUSTER``) and the fundamental extras.
    ``log``: a logging.Logger to write to in place of the run's own.

    ``layout`` (parallel/mesh.Layout): this rank's place, as
    cli/common.launch gives it; by default the process flags'
    (parallel/mesh.host_layout), which must then make one rank a host: on a
    host with more GPUs in use, start the ranks with :func:`run`. The rank
    joins its group (parallel/mesh.join: NCCL on CUDA, gloo for
    ``device="cpu"``); over two or more ranks everything runs over the data
    mesh, and a group of one runs the plain steps (parallel/mesh.use_mesh,
    the validate CLI's rule too). The caller ends the group (:func:`run`
    does)."""
    import torch

    from posetpu_torch import resolve_device
    from posetpu_torch.cli.common import build_model, load_model_variables
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.parallel.mesh import host_layout, join, replicate, use_mesh
    from posetpu_torch.train.checkpoint import CheckpointManager
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_eval_step, make_train_step
    from posetpu_torch.utils.logging import ScalarWriter, create_logger

    if args.epochs:
        cfg.TRAIN.END_EPOCH = args.epochs
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    if layout is None:
        layout = host_layout(args.coordinator, args.num_processes, args.process_id, device)
        if layout.local_ranks > 1:
            raise ValueError(f"setup runs one rank, and this host has {layout.local_ranks} "
                             f"GPUs in use: start one rank per GPU with cli.train.run (or "
                             f"the command), or pin one with device='cuda:<i>'")
    # the 1-D data mesh over every device of every host (the DDP world,
    # train.py:129-225): each rank its rows of the global batch, the model
    # replicated; JAX's asserts on the batch sizes
    local_ndev, world = layout.local_ranks, layout.world
    assert cfg.TRAIN.BATCH_SIZE % local_ndev == 0, (
        f"TRAIN.BATCH_SIZE ({cfg.TRAIN.BATCH_SIZE}) must be a multiple of the local device "
        f"count ({local_ndev}) for even batch sharding")
    assert cfg.TEST.BATCH_SIZE % world == 0, (
        f"TEST.BATCH_SIZE ({cfg.TEST.BATCH_SIZE}) must be a multiple of the total device "
        f"count ({world})")
    group = join(layout, device)
    dev = resolve_device(device) if group is None else group.device
    mesh = use_mesh(group)

    logger, output_dir, tb_dir = create_logger(cfg, args.cfg, "train")
    logger = log or logger
    writer = ScalarWriter(tb_dir)
    logger.info(f"rank {layout.rank} of {world} (host {layout.host} of {layout.hosts}): {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    no_distortion = args.no_distortion or cfg.DATASET.NO_DISTORTION
    train_ds = get_dataset(cfg.DATASET.TRAIN_DATASET)(
        cfg, cfg.DATASET.TRAIN_SUBSET, True,
        pseudo_label_path=args.pseudo_path or cfg.DATASET.PSEUDO_LABEL_PATH,
        no_distortion=no_distortion)
    test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, cfg.DATASET.TEST_SUBSET, False, no_distortion=no_distortion)
    # the reference's DataLoader workers become the image threads, shared by
    # the host's ranks. The loader is sharded by host; each rank takes its
    # rows of the host batch (JAX's make_array_from_process_local_data
    # order), and of every test batch for the mesh eval
    threads = max(1, int(cfg.WORKERS) // local_ndev)
    train_loader = GroupLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=cfg.TRAIN.SHUFFLE,
                               num_shards=layout.hosts, shard_index=layout.host,
                               num_threads=threads, part=(layout.local, local_ndev))
    if cfg.DATASET.IF_SAMPLE and hasattr(train_ds, "group_weights"):
        train_loader.set_weights(train_ds.group_weights(cfg))
        logger.info(f"IF_SAMPLE balancing on: h36m={cfg.DATASET.H36M_WEIGHT} "
                    f"mpii={cfg.DATASET.MPII_WEIGHT}")
    test_loader = GroupLoader(test_ds, cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
                              num_threads=threads,
                              part=(0, 1) if mesh is None else (mesh.rank, mesh.size))
    logger.info(f"train groups: {len(train_ds)}, test groups: {len(test_ds)}")
    logger.info(f"data mesh: {world} devices, {layout.hosts} process(es)")

    gen = torch.Generator().manual_seed(int(cfg.SEED))
    model = build_model(cfg, bf16=not args.f32, generator=gen)
    steps = max(len(train_loader), 1)
    tx = make_optimizer(cfg, steps_per_epoch=steps)
    eval_step = make_eval_step(model, cfg, flip_pairs=train_ds.flip_pairs, mesh=mesh,
                               device=dev)
    prepare = make_prepare_fn(cfg, dev)
    state = init_train_state(model, tx, device=dev)

    # the adversarial path: any MI / domain loss enabled switches to the D/G step
    disc_models = build_discriminators(cfg, gen)
    adversarial = bool(disc_models)
    run_ctx: dict = {"parity": 0}
    if adversarial:
        from posetpu_torch.train.gan import (
            init_discriminator_states,
            make_adversarial_train_step,
        )

        tx_disc = {n: make_optimizer(cfg, steps, discriminator=True) for n in disc_models}
        gan_step = make_adversarial_train_step(model, disc_models, cfg, tx, tx_disc,
                                               mesh=mesh, device=dev, seed=int(cfg.SEED))
        state = {"base_model": state,
                 **init_discriminator_states(disc_models, tx_disc, device=dev)}

        def train_step(states, batch):
            return gan_step(states, batch, epoch_parity=run_ctx["parity"])
    else:
        train_step = make_train_step(model, cfg, tx, mesh=mesh, device=dev)

    tr = Training(cfg, dev, logger, output_dir, writer, train_ds, test_ds, train_loader,
                  test_loader, prepare, eval_step, train_step, state, adversarial, run_ctx,
                  CheckpointManager(output_dir, async_save=True, mesh=mesh),
                  int(cfg.TRAIN.BEGIN_EPOCH), None, mesh=mesh, tx=tx)
    # warm start / resume (train.py:250-286)
    if cfg.TRAIN.RESUME and cfg.TRAIN.RESUME_PATH:
        variables = load_model_variables(cfg.TRAIN.RESUME_PATH,
                                         drop_aggre=not cfg.NETWORK.AGGRE)
        tr.base.params.load_state_dict({**variables["params"], **variables["batch_stats"]})
        tr.base.step = 0
        logger.info(f"=> warm start from {cfg.TRAIN.RESUME_PATH}")
    if cfg.TRAIN.ON_SERVER_CLUSTER and tr.ckpt.exists("checkpoint"):
        _, meta = tr.ckpt.restore("checkpoint", tr.states())
        tr.begin_epoch = int(meta.get("epoch", 0))
        logger.info(f"=> auto-resume at epoch {tr.begin_epoch}")
    if cfg.LOSS.USE_FUNDAMENTAL_LOSS:
        tr.extra = build_fund_extra(cfg, train_ds, dev)
    if mesh is not None:  # every rank starts from rank 0's state
        replicate(tr.states(), mesh)
    return tr


def train_epochs(tr: Training, eval_output_dir: str | None) -> float:
    """The epoch loop from ``tr.begin_epoch`` to ``TRAIN.END_EPOCH``: train,
    validate (the H5 dump into ``eval_output_dir`` where given), the
    per-epoch and best checkpoints (on a better perf, or every
    ``CHECKPOINT_EVERY``), then ``final_state``. Returns the best perf.

    Over a data mesh every rank runs the loop (its rows of each host batch
    and of each test batch); rank 0 logs the steps, writes the scalars, the
    debug drawings, the H5 dump and the checkpoints."""
    from posetpu_torch.parallel.mesh import is_primary, shard_host_batch
    from posetpu_torch.train.loop import train_epoch, validate

    cfg, mesh = tr.cfg, tr.mesh
    primary = is_primary(mesh)
    train_place = None if mesh is None else (lambda t: shard_host_batch(t, mesh))
    best_perf = -1.0
    every = max(1, int(getattr(cfg.TRAIN, "CHECKPOINT_EVERY", 1)))
    debug_dir = (os.path.join(tr.output_dir, "debug") if cfg.DEBUG.DEBUG and primary
                 else None)
    for epoch in range(tr.begin_epoch, cfg.TRAIN.END_EPOCH):
        tr.run_ctx["parity"] = epoch % 2
        tr.state = train_epoch(cfg, tr.train_loader, tr.prepare, tr.train_step, tr.state, epoch,
                               logger=tr.logger if primary else None,
                               writer=tr.writer if primary else None, extra_batch_fn=tr.extra,
                               debug_dir=debug_dir, place_fn=train_place, timer=tr.timer)
        perf, _, _, _ = validate(cfg, tr.test_loader, tr.test_ds, tr.eval_step, tr.base.params,
                                 output_dir=eval_output_dir, logger=tr.logger,
                                 device=tr.device, mesh=mesh)
        if primary:
            tr.writer.add_scalar("valid_perf", perf, epoch)
        is_best = perf > best_perf
        best_perf = max(best_perf, perf)
        if is_best or (epoch + 1) % every == 0:
            tr.ckpt.save_epoch(epoch + 1, tr.states(), perf, is_best)
    tr.ckpt.save_final(tr.states())
    if primary:
        tr.logger.info(f"done; best perf {best_perf:.4f}")
    return best_perf


def _sigterm(_sig, _frm):
    print("SIGTERM received: exiting for cluster resume", file=sys.stderr)
    raise SystemExit(143)


def run(cfg, args, device=None, log=None, local_ranks: int | None = None):
    """Train as ``python -m posetpu_torch.cli.train`` does: one rank per
    GPU in use on this host (parallel/mesh.host_layout; on the CPU
    ``local_ranks`` gloo ranks, default 1), each running :func:`setup` and
    then :func:`train_epochs` with the H5 dump in the output directory
    where h5py is installed (cli/common.launch). While a rank runs,
    SIGTERM exits it at once (code 143) so that a cluster preempting the
    job resumes it (``ON_SERVER_CLUSTER``), as the reference installs it
    (train.py:47-48); the launcher passes it on to every rank. Returns the
    finished Training where the host runs one rank, in this process;
    else None."""
    from posetpu_torch.cli.common import launch
    from posetpu_torch.parallel.mesh import host_layout

    layout = host_layout(args.coordinator, args.num_processes, args.process_id, device,
                         local_ranks)
    return launch(_train, layout, cfg, args, device, log)


def _train(layout, cfg, args, device, log):
    """One rank of :func:`run`: it leaves its group at the end."""
    import torch.distributed as dist

    from posetpu_torch.data import h5io

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _sigterm) if main_thread else None
    try:
        tr = setup(cfg, args, device, log, layout=layout)
        dump_dir = tr.output_dir if h5io.available() else None
        if dump_dir is None:
            tr.logger.info("h5py is not installed: validate writes no heatmap H5 dump")
        try:
            train_epochs(tr, dump_dir)
        finally:
            tr.writer.close()
        return tr
    finally:
        if layout.url is not None and dist.is_initialized():
            dist.destroy_process_group()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)


def main(argv=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    run(load_cfg(args), args)


if __name__ == "__main__":
    main()
