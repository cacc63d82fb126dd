"""Training entry point: run/pose2d/train.py's equivalent.

    python -m posetpu_torch.cli.train --cfg experiments/mixed/resnet50/...yaml \
        [--pseudo-path X.h5] [--no-distortion] [--epochs N] [--batch N] [--f32]

One process on one card (CUDA). The train state warm-starts from
``TRAIN.RESUME_PATH`` (one of the port's own checkpoints: ``<output
dir>/final_state``) and, with ``TRAIN.ON_SERVER_CLUSTER``, resumes from the
run's last ``checkpoint``. An enabled MI or domain loss switches to the
adversarial step. Data parallelism over several processes
(``--coordinator``, ``--num-processes``) is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import threading
from typing import Any, Callable


def parse_args(argv=None):
    from posetpu_torch.cli.common import base_parser

    p = base_parser("Train multi-view pose network")
    p.add_argument("--pseudo-path", default="", help="pseudo label h5")
    p.add_argument("--no-distortion", action="store_true")
    p.add_argument("--epochs", type=int, default=0, help="override END_EPOCH")
    p.add_argument("--batch", type=int, default=0, help="override batch size")
    p.add_argument("--coordinator", default="", help="multi-host coordinator addr")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--f32", action="store_true", help="disable bf16 compute")
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

    @property
    def base(self):
        return self.state["base_model"] if self.adversarial else self.state

    def states(self) -> dict:
        """Every component's train state, as the checkpoints hold them."""
        return self.state if self.adversarial else {"base_model": self.state}


def setup(cfg, args, device=None, log=None) -> Training:
    """Everything before the epoch loop (posetpu/cli/train.py:71-228 for one
    process): the logger and output directories, the data sets and loaders
    (with ``IF_SAMPLE``), the model, optimizer, eval step and prepare, the
    train state and the supervised or adversarial step (the samplers seeded
    from ``cfg.SEED``), the warm start from ``TRAIN.RESUME_PATH``, the
    auto-resume (``TRAIN.ON_SERVER_CLUSTER``) and the fundamental extras.
    ``log``: a logging.Logger to write to in place of the run's own."""
    import torch

    from posetpu_torch import resolve_device
    from posetpu_torch.cli.common import build_model, load_model_variables
    from posetpu_torch.data.loader import GroupLoader
    from posetpu_torch.data.prepare import make_prepare_fn
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.models.discriminators import build_discriminators
    from posetpu_torch.train.checkpoint import CheckpointManager
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state, make_eval_step, make_train_step
    from posetpu_torch.utils.logging import ScalarWriter, create_logger

    if args.coordinator or args.num_processes > 1:
        raise NotImplementedError(
            "--coordinator / --num-processes: training over several processes is not "
            "ported yet (ROADMAP A6)")
    if args.epochs:
        cfg.TRAIN.END_EPOCH = args.epochs
    if args.batch:
        cfg.TRAIN.BATCH_SIZE = args.batch
    dev = resolve_device(device)

    logger, output_dir, tb_dir = create_logger(cfg, args.cfg, "train")
    logger = log or logger
    writer = ScalarWriter(tb_dir)
    logger.info(f"device: {dev}"
                + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    no_distortion = args.no_distortion or cfg.DATASET.NO_DISTORTION
    train_ds = get_dataset(cfg.DATASET.TRAIN_DATASET)(
        cfg, cfg.DATASET.TRAIN_SUBSET, True,
        pseudo_label_path=args.pseudo_path or cfg.DATASET.PSEUDO_LABEL_PATH,
        no_distortion=no_distortion)
    test_ds = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, cfg.DATASET.TEST_SUBSET, False, no_distortion=no_distortion)
    # the reference's DataLoader workers become the loader's image threads
    threads = int(cfg.WORKERS)
    train_loader = GroupLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=cfg.TRAIN.SHUFFLE,
                               num_threads=threads)
    if cfg.DATASET.IF_SAMPLE and hasattr(train_ds, "group_weights"):
        train_loader.set_weights(train_ds.group_weights(cfg))
        logger.info(f"IF_SAMPLE balancing on: h36m={cfg.DATASET.H36M_WEIGHT} "
                    f"mpii={cfg.DATASET.MPII_WEIGHT}")
    test_loader = GroupLoader(test_ds, cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
                              num_threads=threads)
    logger.info(f"train groups: {len(train_ds)}, test groups: {len(test_ds)}")

    gen = torch.Generator().manual_seed(int(cfg.SEED))
    model = build_model(cfg, bf16=not args.f32, generator=gen)
    steps = max(len(train_loader), 1)
    tx = make_optimizer(cfg, steps_per_epoch=steps)
    eval_step = make_eval_step(model, cfg, flip_pairs=train_ds.flip_pairs, device=dev)
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
                                               device=dev, seed=int(cfg.SEED))
        state = {"base_model": state,
                 **init_discriminator_states(disc_models, tx_disc, device=dev)}

        def train_step(states, batch):
            return gan_step(states, batch, epoch_parity=run_ctx["parity"])
    else:
        train_step = make_train_step(model, cfg, tx, device=dev)

    tr = Training(cfg, dev, logger, output_dir, writer, train_ds, test_ds, train_loader,
                  test_loader, prepare, eval_step, train_step, state, adversarial, run_ctx,
                  CheckpointManager(output_dir, async_save=True), int(cfg.TRAIN.BEGIN_EPOCH),
                  None)
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
    return tr


def train_epochs(tr: Training, eval_output_dir: str | None) -> float:
    """The epoch loop from ``tr.begin_epoch`` to ``TRAIN.END_EPOCH``: train,
    validate (the H5 dump into ``eval_output_dir`` where given), the
    per-epoch and best checkpoints (on a better perf, or every
    ``CHECKPOINT_EVERY``), then ``final_state``. Returns the best perf."""
    from posetpu_torch.train.loop import train_epoch, validate

    cfg = tr.cfg
    best_perf = -1.0
    every = max(1, int(getattr(cfg.TRAIN, "CHECKPOINT_EVERY", 1)))
    debug_dir = os.path.join(tr.output_dir, "debug") if cfg.DEBUG.DEBUG else None
    for epoch in range(tr.begin_epoch, cfg.TRAIN.END_EPOCH):
        tr.run_ctx["parity"] = epoch % 2
        tr.state = train_epoch(cfg, tr.train_loader, tr.prepare, tr.train_step, tr.state, epoch,
                               logger=tr.logger, writer=tr.writer, extra_batch_fn=tr.extra,
                               debug_dir=debug_dir, timer=tr.timer)
        perf, _, _, _ = validate(cfg, tr.test_loader, tr.test_ds, tr.eval_step, tr.base.params,
                                 output_dir=eval_output_dir, logger=tr.logger, device=tr.device)
        tr.writer.add_scalar("valid_perf", perf, epoch)
        is_best = perf > best_perf
        best_perf = max(best_perf, perf)
        if is_best or (epoch + 1) % every == 0:
            tr.ckpt.save_epoch(epoch + 1, tr.states(), perf, is_best)
    tr.ckpt.save_final(tr.states())
    tr.logger.info(f"done; best perf {best_perf:.4f}")
    return best_perf


def _sigterm(_sig, _frm):
    print("SIGTERM received: exiting for cluster resume", file=sys.stderr)
    raise SystemExit(143)


def run(cfg, args, device=None, log=None) -> Training:
    """Train as ``python -m posetpu_torch.cli.train`` does: :func:`setup`,
    then :func:`train_epochs` with the H5 dump in the output directory.
    While it runs, SIGTERM exits at once (code 143) so that a cluster
    preempting the job resumes it (``ON_SERVER_CLUSTER``), as the reference
    installs it (train.py:47-48). Returns the finished Training."""
    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, _sigterm) if main_thread else None
    try:
        tr = setup(cfg, args, device, log)
        try:
            train_epochs(tr, tr.output_dir)
        finally:
            tr.writer.close()
        return tr
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, previous)


def main(argv=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    run(load_cfg(args), args)


if __name__ == "__main__":
    main()
