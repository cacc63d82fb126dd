"""One command on every device of a host (cli/common.launch,
parallel/mesh.Layout) on the CPU, and the batched warp (ops/warp.py):

- the rank -> (host, local) -> rows map at 2 hosts x 2 local ranks, and the
  loaders of the four ranks joined against the JAX package's two host
  loaders (shuffle, ``IF_SAMPLE`` weights, each record's draws), bit for
  bit, each rank completing only its own records;
- on one host with two gloo ranks, the train CLI's ``setup``: the ranks'
  rows of steps 0 and 1 joined equal the host batch of the JAX package's
  loader built as posetpu/cli/train.py:126-130 builds it, bit for bit; the
  steps an epoch and the learning rate at steps 0..len equal JAX's; the
  first step over the two ranks in float64 equals the port's plain step
  on that host batch within 1e-10;
- the validate CLI over two local ranks equals one, and the pipeline's
  train stage over two its BatchNorm statistics;
- the launcher: a rank that fails stops its siblings and raises at once;
  SIGTERM reaches every rank, and the command exits with 143;
- ``affine_warp_batch`` against JAX's ``vmap`` of the single warp.

The ranks are spawned by the launcher itself (``local_ranks=2``); each
writes what the parent compares."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from posetpu_torch.cli import train as tcli
from posetpu_torch.cli import validate as vcli
from posetpu_torch.cli.common import build_model, launch, load_cfg
from posetpu_torch.data.loader import COLLATE_KEYS, GroupLoader
from posetpu_torch.parallel.mesh import Layout, host_layout

MPII = "experiments/mpii/resnet50/140e_32batch.yaml"
REPO = Path(__file__).resolve().parents[1]
B = 2  # groups in a host batch


# ------------------------------------------------------ the layout alone


class DrawDataset:
    """Groups whose records are made of the loader's draws: a deferred
    record's image is a function of its draws, made when the loader
    completes it (``finalize_record``, counted); with ``defer=False`` the
    records come whole, as the JAX loader takes them."""

    def __init__(self, n: int, defer: bool):
        self.n, self.defer, self.finalized = n, defer, []

    def __len__(self):
        return self.n

    def load_group(self, g, rs, defer_images=False):
        views = []
        for v in range(2):
            draw = rs.uniform(size=3)
            rec = {"joints_crop": np.full((2, 2), g, np.float32), "joints_vis": draw[:2],
                   "supervise": np.float32(1), "center": draw[:2], "scale": draw[1:],
                   "rotation": draw[2], "joints_2d": np.full((2, 2), v, np.float32),
                   "is_h36m": np.float32(g % 2), "subject": np.int32(g)}
            job = {"g": g, "draw": draw}
            if self.defer and defer_images:
                rec["_image_job"] = job
            else:
                rec["image"] = self._image(job)
            views.append(rec)
        return views

    @staticmethod
    def _image(job):
        return np.full((3, 2, 3), job["g"], np.float32) + job["draw"][0]

    def finalize_record(self, rec):
        job = rec.pop("_image_job")
        self.finalized.append(job["g"])
        rec["image"] = self._image(job)


def test_layout_two_hosts_two_local_ranks(monkeypatch):
    """The world, each rank's (host, local) and rows; the four ranks'
    loaders joined in rank order are the two hosts' JAX batches joined, as
    make_array_from_process_local_data lays them, bit for bit."""
    from posetpu.data.loader import GroupLoader as JaxLoader

    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    hosts, local, batch = 2, 2, 4
    layouts = [Layout(hosts, h, local, i) for h in range(hosts) for i in range(local)]
    assert [(x.rank, x.world) for x in layouts] == [(r, 4) for r in range(4)]
    assert [x.rows(batch) for x in layouts] == [(0, 2), (2, 4)] * 2
    with pytest.raises(ValueError):
        layouts[0].rows(3)
    assert host_layout("10.0.0.1:1234", 2, 1, "cpu", 2) == Layout(2, 1, 2, 0,
                                                                   "tcp://10.0.0.1:1234")
    assert host_layout(device="cpu") == Layout()
    for bad in (dict(num_processes=2), dict(coordinator="h:1", num_processes=2, process_id=2)):
        with pytest.raises(ValueError):
            host_layout(device="cpu", **bad)

    weights = np.random.RandomState(1).uniform(0.5, 2.0, 11)
    for epoch in (0, 1):
        ref, got = [], []
        for h in range(hosts):
            jl = JaxLoader(DrawDataset(11, defer=False), batch, num_shards=hosts,
                           shard_index=h, prefetch=0)
            jl.set_weights(weights)
            jl.set_epoch(epoch)
            ref.append(list(jl))
        for x in layouts:
            ds = DrawDataset(11, defer=True)
            tl = GroupLoader(ds, batch, num_shards=x.hosts, shard_index=x.host, prefetch=0,
                             num_threads=1, part=(x.local, x.local_ranks))
            tl.set_weights(weights)
            tl.set_epoch(epoch)
            got.append(list(tl))
            assert len(tl) == len(jl) == 1
            # this rank completed its own rows' records alone
            own = np.concatenate([b["subject"] for b in got[-1]])
            assert sorted(ds.finalized) == sorted(np.repeat(own, 2).tolist())
        for b in range(len(ref[0])):
            want = {k: np.concatenate([r[b][k] for r in ref]) for k in ref[0][b]}
            assert set(want) == set(got[0][b])
            for k, v in want.items():
                joined = np.concatenate([g[b][k] for g in got])
                assert joined.dtype == v.dtype and np.array_equal(joined, v), (epoch, b, k)


def test_part_of_a_short_last_batch():
    """drop_last=False: the last batch padded to the batch size by wrapping
    around its groups before it is split, its groups counted unpadded."""
    parts = [GroupLoader(DrawDataset(5, defer=True), 4, shuffle=False, drop_last=False,
                         prefetch=0, num_threads=1, part=(i, 2)) for i in range(2)]
    got = [[b["subject"].tolist() for b in tl] for tl in parts]
    assert got == [[[0, 1], [4, 4]], [[2, 3], [4, 4]]]
    assert [parts[0].batch_rows(b) for b in range(2)] == [4, 1]
    with pytest.raises(ValueError):
        GroupLoader(DrawDataset(5, defer=True), 3, part=(0, 2))


# ------------------------------------------------------ the launcher


def failing_rank(layout, out: Path) -> None:
    """Local rank 1 fails after the rendezvous; rank 0 then waits for it in
    a barrier that only the launcher can end."""
    import torch.distributed as dist

    from posetpu_torch.parallel.mesh import join

    join(layout, "cpu", timeout=120)
    (out / f"pid{layout.local}").write_text(str(os.getpid()))
    if layout.local == 1:
        raise RuntimeError("local rank 1 fails")
    dist.barrier()


def sleeping_rank(layout, out: Path) -> None:
    """A rank that waits with the train CLI's SIGTERM handler installed."""
    import signal
    import time

    signal.signal(signal.SIGTERM, tcli._sigterm)
    (out / f"pid{layout.local}").write_text(str(os.getpid()))
    time.sleep(120)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_a_failed_rank_stops_its_siblings(tmp_path):
    """The failure is raised with the rank's traceback long before the
    collective's 120 s timeout, and no rank is left running."""
    import time

    t = time.monotonic()
    with pytest.raises(Exception, match="local rank 1 fails"):
        launch(failing_rank, host_layout(device="cpu", local_ranks=2), tmp_path)
    assert time.monotonic() - t < 60
    pids = [int((tmp_path / f"pid{i}").read_text()) for i in range(2)]
    assert all(_gone(p) for p in pids)


def test_sigterm_reaches_every_rank(tmp_path):
    """SIGTERM to the launching process reaches both ranks, which exit with
    143 (the train CLI's handler), and so does the launcher."""
    import signal
    import subprocess
    import sys
    import time

    code = ("import sys; from pathlib import Path; from tests.test_torch_launch import *; "
            "launch(sleeping_rank, host_layout(device='cpu', local_ranks=2), Path(sys.argv[1]))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO)
    try:
        deadline = time.monotonic() + 90
        while not all((tmp_path / f"pid{i}").exists() for i in range(2)):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        proc.kill()
    pids = [int((tmp_path / f"pid{i}").read_text()) for i in range(2)]
    time.sleep(0.5)
    assert all(_gone(p) for p in pids)


# ------------------------------------------------------ two local ranks


def cli_args(module, out: Path, *extra):
    return module.parse_args(["--cfg", str(REPO / MPII), "--modelDir", str(out / "output"),
                              "--logDir", str(out / "log"), "--f32", *extra])


def cli_cfg(args, data: Path):
    """The MPII preset cut to ResNet-18 at 64x64, ``B`` groups a host batch,
    one epoch; the learning rate steps down after epoch 1, so that steps
    0..len of the schedule cross a boundary."""
    cfg = load_cfg(args)
    cfg.DATASET.ROOT = str(data)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = B
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.LR_STEP = [1]
    cfg.DEBUG.DEBUG = False
    cfg.WORKERS = 1
    return cfg


def f64_model(cfg, state_dict):
    from posetpu_torch.models.multiview import get_multiview_pose_net

    model = get_multiview_pose_net(cfg, None, torch.float64)
    model.load_state_dict(state_dict)
    return model.to(torch.float64)


def f64_step(cfg, state_dict, host_rows, prepare, mesh, steps: int):
    """One float64 step from ``state_dict`` on the prepared rows: the
    metrics and the gradients."""
    from posetpu_torch.train import step as tstep
    from posetpu_torch.train.optim import make_optimizer

    model = f64_model(cfg, state_dict)
    tx = make_optimizer(cfg, steps_per_epoch=steps)
    step = tstep.make_train_step(model, cfg, tx, mesh=mesh, device="cpu")
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in prepare(host_rows).items()}
    _, m = step(tstep.init_train_state(model, tx, device="cpu"), batch)
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None})


def setup_rank(layout, out: Path, data: Path) -> None:
    """A local rank of the train CLI's ``setup``: its rows of steps 0 and
    1, the steps an epoch, the schedule, the first step in float64 over
    the mesh; rank 0 also the initial weights."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    args = cli_args(tcli, out)
    cfg = cli_cfg(args, data)
    tr = tcli.setup(cfg, args, device="cpu", layout=layout)
    try:
        tr.train_loader.set_epoch(0)
        it = iter(tr.train_loader)
        rows = [next(it), next(it)]
        it.close()
        steps = len(tr.train_loader)
        weights = {k: v.clone() for k, v in tr.base.params.state_dict().items()}
        metrics, grads = f64_step(cfg, weights, rows[0], tr.prepare, tr.mesh, steps)
        res = {"rows": rows, "steps": steps, "mesh": (tr.mesh.rank, tr.mesh.size),
               "lr": [float(tr.tx.schedule(c)) for c in range(steps + 1)],
               "metrics": metrics, "grads": grads}
        if layout.rank == 0:
            res["weights"] = weights
        torch.save(res, out / f"rank{layout.rank}.pt")
    finally:
        tr.writer.close()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The image fixture (MPII: 4 train groups, 3 validation), then two
    local gloo ranks through the launcher running :func:`setup_rank`."""
    from posetpu_torch.data.synthetic import write_image_fixture

    base = tmp_path_factory.mktemp("launch")
    write_image_fixture(str(base / "data"), n_images=8, mpii_size=(96, 72),
                        h36m_size=(120, 120), mpii_train=16, mpii_valid=12,
                        h36m_train_groups=2, h36m_valid_groups=1, seed=5)
    args = cli_args(tcli, base)
    layout = host_layout(device="cpu", local_ranks=2)
    assert (layout.local_ranks, layout.url) == (2, None)
    launch(setup_rank, layout, base, base / "data")
    return {"dir": base, "ranks": [torch.load(base / f"rank{r}.pt", weights_only=False)
                                   for r in range(2)],
            "cfg": cli_cfg(args, base / "data")}


def jax_host_loader(cfg_path: str, data: Path):
    """The JAX package's train loader, as posetpu/cli/train.py:126-130
    builds it on one process, and its learning-rate schedule (the one
    posetpu.train.optim.make_optimizer builds)."""
    from posetpu.cli.common import load_cfg as jax_load_cfg
    from posetpu.data.loader import GroupLoader as JaxLoader
    from posetpu.data.registry import get_dataset
    from posetpu.train import optim as joptim

    jargs = argparse.Namespace(cfg=cfg_path, modelDir="", logDir="", dataDir="")
    cfg = jax_load_cfg(jargs)
    cfg.DATASET.ROOT = str(data)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = B
    cfg.TRAIN.LR_STEP = [1]
    train_ds = get_dataset(cfg.DATASET.TRAIN_DATASET)(
        cfg, cfg.DATASET.TRAIN_SUBSET, True, pseudo_label_path=cfg.DATASET.PSEUDO_LABEL_PATH,
        no_distortion=cfg.DATASET.NO_DISTORTION)
    loader = JaxLoader(train_ds, cfg.TRAIN.BATCH_SIZE, shuffle=cfg.TRAIN.SHUFFLE,
                       num_shards=1, shard_index=0)
    if cfg.DATASET.IF_SAMPLE and hasattr(train_ds, "group_weights"):
        loader.set_weights(train_ds.group_weights(cfg))
    made = []
    multistep = joptim.multistep_lr

    def recording(*a, **kw):
        made.append(multistep(*a, **kw))
        return made[-1]

    joptim.multistep_lr = recording
    try:
        joptim.make_optimizer(cfg, steps_per_epoch=max(len(loader), 1))
    finally:
        joptim.multistep_lr = multistep
    return loader, made[0]


def test_two_local_ranks_draw_the_jax_host_batch(ranks, monkeypatch):
    """Steps 0 and 1: the two ranks' rows joined are the JAX loader's host
    batch, bit for bit; the ranks' steps an epoch and schedule are JAX's."""
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    r0, r1 = ranks["ranks"]
    assert r0["mesh"] == (0, 2) and r1["mesh"] == (1, 2)
    loader, schedule = jax_host_loader(str(REPO / MPII), ranks["dir"] / "data")
    loader.set_epoch(0)
    it = iter(loader)
    host = [next(it), next(it)]
    it.close()
    for b in range(2):
        assert set(host[b]) == set(r0["rows"][b]) == {*COLLATE_KEYS, "images"} - {"image"}
        for k, v in host[b].items():
            joined = np.concatenate([r0["rows"][b][k], r1["rows"][b][k]])
            assert r0["rows"][b][k].shape[0] == B // 2
            assert joined.dtype == v.dtype and np.array_equal(joined, v), (b, k)
    assert r0["steps"] == r1["steps"] == len(loader) == 2
    want = [float(schedule(c)) for c in range(len(loader) + 1)]
    assert r0["lr"] == r1["lr"] == want and want[-1] < want[0]


def test_first_step_over_two_local_ranks_equals_the_plain_step(ranks):
    """The first step in float64 over the two ranks against the plain step
    on the host batch (the ranks' rows joined): the metrics and the
    all-reduced gradients within 1e-10 of each one's largest entry."""
    from posetpu_torch.data.prepare import make_prepare_fn

    r0, r1 = ranks["ranks"]
    cfg = ranks["cfg"]
    host = {k: np.concatenate([r0["rows"][0][k], r1["rows"][0][k]]) for k in r0["rows"][0]}
    metrics, grads = f64_step(cfg, r0["weights"], host, make_prepare_fn(cfg, "cpu"), None,
                              r0["steps"])
    for r in (r0, r1):
        assert set(r["metrics"]) == set(metrics) and "loss" in metrics
        for k, v in metrics.items():
            assert abs(r["metrics"][k] - v) <= 1e-10 * max(abs(v), 1e-300), (k, v)
        assert set(r["grads"]) == set(grads)
        for k, g in grads.items():
            err = float((r["grads"][k] - g).abs().max())
            assert err <= 1e-10 * max(float(g.abs().max()), 1e-300), (k, err)


def test_validate_cli_over_two_local_ranks_equals_one(ranks):
    """On a checkpoint of the setup's weights, 3 validation groups in
    batches of 2 (the last one padded): the preds, heatmaps and perf of two
    local ranks (local rank 0's, sent back by the launcher) against one."""
    from posetpu_torch.train.checkpoint import CheckpointManager
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state

    base = ranks["dir"]
    cfg = ranks["cfg"]
    model = build_model(cfg, bf16=False)
    model.load_state_dict(ranks["ranks"][0]["weights"])
    CheckpointManager(str(base / "ckpt")).save_final(
        {"base_model": init_train_state(model, make_optimizer(cfg, 1), device="cpu")})
    vargs = cli_args(vcli, base, "--state", str(base / "ckpt" / "final_state"))
    vcfg = cli_cfg(vargs, base / "data")
    two = vcli.run(vcfg, vargs, device="cpu", dump=False, local_ranks=2)
    vcfg = cli_cfg(vargs, base / "data")
    one = vcli.run(vcfg, vargs, device="cpu", dump=False)
    assert two[2].shape == one[2].shape == (3 * 4, 16, 3)
    np.testing.assert_allclose(two[2], one[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(two[3], one[3], rtol=0, atol=1e-5)
    assert two[0] == pytest.approx(one[0], abs=1e-6)


def test_pipeline_train_stage_over_two_local_ranks(ranks):
    """The self-training loop's train stage (cli/pipeline._train_stage)
    through the launcher on two local ranks, one step of the 4 groups:
    rank 0 writes the final_state, whose BatchNorm running statistics (the
    global batch's moments) equal one rank's within 1e-5 of each buffer's
    largest; the parameters are Adam's first step, which moves a
    rounding-noise gradient by +-lr, so they are not compared."""
    from posetpu_torch.cli import pipeline as tpipe
    from posetpu_torch.train.checkpoint import CheckpointManager

    base = ranks["dir"]
    saved = {}
    for n in (1, 2):
        args = tpipe.parse_args(["--cfg", str(REPO / MPII), "--modelDir", str(base / f"pipe{n}"),
                                 "--logDir", str(base / f"pipe_log{n}"), "--epochs", "1"])
        cfg = cli_cfg(args, base / "data")
        cfg.TRAIN.BATCH_SIZE = 4
        out = launch(tpipe._train_stage, host_layout(device="cpu", local_ranks=n), cfg, args,
                     "", 0, "cpu", collect=True)
        out_dir = out[1] if n == 1 else out
        saved[n] = CheckpointManager(out_dir).restore_model("final_state")["base_model"]
    stats = saved[1]["batch_stats"]
    assert set(saved[2]["batch_stats"]) == set(stats) and stats
    for k, v in stats.items():
        err = float((saved[2]["batch_stats"][k] - v).abs().max())
        assert err <= 1e-5 * float(v.abs().max()), (k, err)


# ------------------------------------------------------ the batched warp


def test_affine_warp_batch_matches_jax_vmap(rng):
    """Three images, each with its own affine, some samples past the
    border: within the single warp's bounds (tests/test_torch_train.py)."""
    from posetpu.ops import warp as jwarp
    from posetpu.ops.affine import get_affine_transform
    from posetpu_torch.ops import warp as twarp

    imgs = rng.rand(3, 40, 50, 3).astype(np.float32)
    inv = np.stack([np.asarray(get_affine_transform(np.array(c), np.array([s, s]), r, (32, 24),
                                                    inv=True), np.float32)
                    for c, s, r in (([25.0, 18.0], 0.2, 17.0), ([5.0, 35.0], 0.3, -40.0),
                                    ([48.0, 2.0], 0.15, 90.0))])
    ref = np.asarray(jwarp.affine_warp_batch(imgs, inv, (32, 24)))
    got = twarp.affine_warp_batch(torch.from_numpy(imgs), torch.from_numpy(inv), (32, 24))
    assert got.shape == (3, 24, 32, 3)
    assert all(float((got[i] == 0).float().mean()) > 0.05 for i in (1, 2))  # past the border
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    one = twarp.affine_warp_image(torch.from_numpy(imgs[1]), torch.from_numpy(inv[1]), (32, 24))
    assert torch.equal(one, got[1])
