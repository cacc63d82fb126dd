"""The port's epoch loop (train/loop.py) and the utilities it runs
(utils/{logging,checks,profiling}.py) against the JAX package on the CPU.

- ``train_epoch`` over two mixed MPII + H36M batches (the fundamental loss
  from the fixture's cameras) from one carried state in f32 (ResNet-18,
  64x64, 16x16 maps, the bank): each step's loss and terms and the final
  parameters within tests/test_torch_train.py's bounds (its first step's
  for the first step, its three steps' for the second);
- ``validate`` on MPII's validation set with the flip test: the preds,
  the heatmaps, the H5 dump and the PCKh within test_torch_train.py's
  eval-step bounds;
- the loop's logging line, scalars and debug drawings; ``place_fn``
  placing each batch before ``prepare``; ``_pad_host_batch``;
- the logger's layout, ``scalars.jsonl`` byte for byte, the meters, the
  batch-shape and finite-metric guards, the step timer and the trace."""

from __future__ import annotations

import json
import logging
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.cli.train import build_fund_extra as jax_fund_extra
from posetpu.config import default_config as jax_config
from posetpu.data import loader as jloader
from posetpu.data import registry as jregistry
from posetpu.data.prepare import make_prepare_fn as jax_prepare_fn
from posetpu.models import MultiViewPose as JMultiView
from posetpu.models import get_pose_net as jax_pose_net
from posetpu.train import loop as jloop
from posetpu.train import optim as joptim
from posetpu.train import step as jstep
from posetpu.train.state import TrainState as JState
from posetpu.utils import checks as jchecks
from posetpu.utils import logging as jlogging
from posetpu_torch.cli.train import build_fund_extra
from posetpu_torch.config import default_config
from posetpu_torch.data import loader as tloader
from posetpu_torch.data import registry as tregistry
from posetpu_torch.data.prepare import make_prepare_fn
from posetpu_torch.models.convert import from_jax_train_state, from_jax_variables
from posetpu_torch.models.multiview import MultiViewPose
from posetpu_torch.models.pose_resnet import PoseResNet
from posetpu_torch.train import loop as tloop
from posetpu_torch.train import step as tstep
from posetpu_torch.train.optim import make_optimizer
from posetpu_torch.utils import checks as tchecks
from posetpu_torch.utils import logging as tlogging
from posetpu_torch.utils import profiling as tprof
from tests.test_torch_data_images import write_fixture
from tests.test_torch_serving_jns import np_variables
from tests.test_torch_train import _compare_state


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp("loop"), "zip")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this module trains: under a parallel test
    run, eight a process oversubscribe the cores and each step waits on
    its slowest thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(root, **over):
    """(JAX, port) configs: ResNet-18 with the bank at 64x64 / 16x16, the
    MPII augmentation and the fundamental loss on, Adam at 1e-4."""
    out = []
    for make in (jax_config, default_config):
        c = make()
        c.DATASET.ROOT, c.DATASET.DATA_FORMAT = str(root), "zip"
        c.NETWORK.IMAGE_SIZE, c.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
        c.POSE_RESNET.NUM_LAYERS = 18
        c.NETWORK.AGGRE = True
        c.DATASET.MPII_SCALE_FACTOR, c.DATASET.MPII_ROT_FACTOR = 0.25, 30
        c.DATASET.MPII_FLIP = True
        c.LOSS.USE_FUNDAMENTAL_LOSS = True
        c.LOSS.USE_TARGET_WEIGHT_FUND = False  # as the mixed presets: h36m has no labels
        c.TRAIN.LR = 1e-4
        c.PRINT_FREQ = 1
        c.DEBUG.DEBUG = False
        for k, v in over.items():
            sec, key = k.split(".")
            setattr(getattr(c, sec), key, v)
        out.append(c)
    return out


def _mixed(root, monkeypatch, jcfg, tcfg):
    """The mixed train sets cut to two h36m and two mpii groups."""
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    out = []
    for reg, cfg in ((jregistry, jcfg), (tregistry, tcfg)):
        ds = reg.get_dataset("mixed")(cfg, "train", True)
        n = len(ds.h36m)
        ds.grouping = ds.grouping[:2] + ds.grouping[n:n + 2]
        out.append(ds)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_epoch_matches_jax_from_one_carried_state(root, monkeypatch, rng):
    jcfg, tcfg = _cfgs(root)
    jds, tds = _mixed(root, monkeypatch, jcfg, tcfg)
    variables = np_variables(rng)
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=True)
    jtx = joptim.make_optimizer(jcfg, 2)
    jtrain = jstep.make_train_step(jmodel, jcfg, jtx)
    jstate = JState(variables["params"], variables["batch_stats"], jtx.init(variables["params"]), 0)
    tx = make_optimizer(tcfg, 2)
    model = MultiViewPose(PoseResNet(num_layers=18), heatmap_size=16)
    state = from_jax_train_state(_np(jstate), model, tx, device="cpu")
    ttrain = tstep.make_train_step(model, tcfg, tx, device="cpu")

    def recording(step, out):
        def run(st, batch):
            st, m = step(st, batch)
            out.append({k: float(v) for k, v in m.items()})
            return st, m
        return run

    jms, tms = [], []
    jstate = jloop.train_epoch(jcfg, jloader.GroupLoader(jds, 2, seed=3), jax_prepare_fn(jcfg),
                               recording(jtrain, jms), jstate, 1,
                               extra_batch_fn=jax_fund_extra(jcfg, jds))
    state = tloop.train_epoch(tcfg, tloader.GroupLoader(tds, 2, seed=3),
                              make_prepare_fn(tcfg, "cpu"), recording(ttrain, tms), state, 1,
                              extra_batch_fn=build_fund_extra(tcfg, tds, "cpu"))
    assert len(tms) == len(jms) == 2 and state.step == int(jstate.step) == 2
    for i, (got, ref) in enumerate(zip(tms, jms)):
        assert set(got) == set(ref) and all(np.isfinite(v) for v in got.values())
        for k in ref:
            if i == 0:
                rtol = 1e-4 if "fund" in k else 1e-5
            else:
                rtol = 3e-2 if "fund" in k else 2e-3
            np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=1e-7, err_msg=(i, k))
    assert max(m["fund_loss"] for m in tms) > 0
    _compare_state(state, jstate, param_atol=6 * tcfg.TRAIN.LR, frac=1.0, stats_rtol=1e-2)


def test_validate_matches_jax_with_the_flip_test(root, monkeypatch, rng, tmp_path):
    """Preds, maxvals, heatmaps and the H5 dump within the eval step's
    bounds (tests/test_torch_train.py::test_eval_step_with_flip_matches_jax),
    the PCKh as JAX's on the same preds."""
    jcfg, tcfg = _cfgs(root, **{"TEST.FLIP_TEST": True, "TEST.SHIFT_HEATMAP": True,
                                "TEST.POST_PROCESS": True, "NETWORK.AGGRE": False})
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    jds = jregistry.get_dataset("mpii")(jcfg, "valid", False)
    tds = tregistry.get_dataset("mpii")(tcfg, "valid", False)
    variables = np_variables(rng)
    variables["params"].pop("aggre_layer")
    jmodel = JMultiView(resnet=jax_pose_net(jcfg), aggre=False)
    jeval = jstep.make_eval_step(jmodel, jcfg, flip_pairs=jds.flip_pairs)
    model = MultiViewPose(PoseResNet(num_layers=18))
    model.load_state_dict(from_jax_variables(_np(variables)))
    teval = tstep.make_eval_step(model, tcfg, flip_pairs=tds.flip_pairs, device="cpu")
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    kw = dict(shuffle=False, drop_last=False)
    jperf, jnv, jpreds, jhm = jloop.validate(jcfg, jloader.GroupLoader(jds, 3, **kw), jds, jeval,
                                             variables, output_dir=str(tmp_path / "j"))
    perf, nv, preds, hm = tloop.validate(tcfg, tloader.GroupLoader(tds, 3, **kw), tds, teval,
                                         model, output_dir=str(tmp_path / "t"), device="cpu")
    assert preds.shape == jpreds.shape == (len(tds) * 4, 16, 3) and hm.shape == jhm.shape
    rng_ = jhm.max() - jhm.min()
    np.testing.assert_allclose(hm, jhm, rtol=0, atol=1e-5 * rng_)
    np.testing.assert_allclose(preds[..., 2], jpreds[..., 2], rtol=1e-4, atol=1e-5 * rng_)
    pos = jpreds[..., 2] > 0
    same = np.abs(preds[..., :2] - jpreds[..., :2]).max(-1) <= 1e-3
    assert pos.mean() > 0 and same[pos].mean() >= 0.95, (pos.mean(), same[pos].mean())
    assert list(nv) == list(jnv)
    np.testing.assert_allclose(perf, tds.evaluate(preds[:, :, :2])[1], rtol=0, atol=0)
    np.testing.assert_allclose(perf, jperf, rtol=0, atol=1.0 / pos.sum())
    name = "heatmaps_locations_valid_mpii.h5"
    with h5py.File(tmp_path / "t" / name) as f, h5py.File(tmp_path / "j" / name) as g:
        assert sorted(f) == sorted(g)
        np.testing.assert_array_equal(f["joint_names_order"], g["joint_names_order"])
        np.testing.assert_allclose(f["heatmaps"], g["heatmaps"], rtol=0, atol=1e-5 * rng_)
        np.testing.assert_array_equal(f["locations"], preds)


def test_train_epoch_logs_scalars_and_debug_images(root, monkeypatch, tmp_path, caplog):
    """With a logger: one line a PRINT_FREQ step, the scalars by step, and
    the reference's four debug drawings of the first view."""
    _, tcfg = _cfgs(root, **{"DEBUG.DEBUG": True, "LOSS.USE_FUNDAMENTAL_LOSS": False,
                             "NETWORK.AGGRE": False})
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    tds = tregistry.get_dataset("mpii")(tcfg, "train", True)
    model = MultiViewPose(PoseResNet(num_layers=18))
    tx = make_optimizer(tcfg, 3)
    state = tstep.init_train_state(model, tx, device="cpu")
    writer = tlogging.ScalarWriter(str(tmp_path / "tb"))
    logger = logging.getLogger("test_torch_loop")
    timer = tprof.StepTimer()
    loader = tloader.GroupLoader(tds, 2, seed=0)
    with caplog.at_level(logging.INFO, logger="test_torch_loop"):
        state = tloop.train_epoch(tcfg, loader, make_prepare_fn(tcfg, "cpu"),
                                  tstep.make_train_step(model, tcfg, tx, device="cpu"), state, 0,
                                  logger=logger, writer=writer, debug_dir=str(tmp_path / "dbg"),
                                  timer=timer)
    writer.close()
    n = len(loader)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == n and lines[0].startswith(f"Epoch [0][0/{n}] Speed ")
    assert "mse_loss" in lines[0] and "h36m 0.0% other 100.0%" in lines[0]
    assert len(timer.data_times) == len(timer.step_times) == n
    rows = [json.loads(x) for x in open(tmp_path / "tb" / "scalars.jsonl")]
    assert {r["tag"] for r in rows} == {"train_loss", "train_mse_loss", "train_acc"}
    assert sorted({r["step"] for r in rows}) == list(range(1, n + 1))
    drawn = sorted(os.listdir(tmp_path / "dbg"))
    assert len(drawn) == 4 * n and drawn[0] == "train_view1_00000000_gt.jpg"


class _Loader:
    """Host batches of 3, 3 and 1 groups (the last one ragged)."""

    batch_size = 3

    def __init__(self):
        self.batches = [{"images": np.full((n, 4, 2, 2, 3), i, np.uint8),
                         "is_h36m": np.zeros(n, np.float32),
                         "joints_crop": np.zeros((n, 4, 2, 2), np.float32),
                         "joints_vis": np.ones((n, 4, 2), np.float32),
                         "supervise": np.ones(n, np.float32),
                         "center": np.full((n, 4, 2), i, np.float32),
                         "scale": np.ones((n, 4, 2), np.float32)}
                        for i, n in enumerate((3, 3, 1))]

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


class _Dataset:
    u2a_mapping = {0: 0, 1: 1}
    subset, dataset_type = "valid", "fake"

    def evaluate(self, preds, output_dir):
        return {"PCKh": 0.5}, float(preds.shape[0])


@pytest.mark.parametrize("where", ["train_epoch", "validate", "eval_prepare"])
def test_place_fn_places_each_batch_before_prepare(where):
    """``place_fn`` (parallel/mesh's shard_host_batch for train,
    global_batch_from_full_host for validate) takes every host batch before
    ``prepare``; validate pads the ragged last batch to the batch size
    first and keeps the true rows."""
    placed = []

    def place(tree):
        placed.append(len(tree["images"]))
        return {**tree, "placed": np.ones(len(tree["images"]))}

    def prepare(host_batch):
        assert "placed" in host_batch
        return {k: torch.as_tensor(v) for k, v in host_batch.items()}

    if where == "train_epoch":
        seen = []

        def step(state, batch):
            seen.append(float(batch["placed"].sum()))
            return state, {"loss": torch.tensor(1.0)}

        assert tloop.train_epoch(default_config(), _Loader(), prepare, step, "s", 0,
                                 place_fn=place) == "s"
        assert placed == [3, 3, 1] and seen == [3.0, 3.0, 1.0]
    elif where == "validate":
        def eval_step(variables, batch):
            n = len(batch["images"])
            return {"loss": torch.tensor(1.0), "acc": torch.tensor(0.5),
                    "preds": batch["center"][:, :, None, :].expand(n, 4, 2, 2),
                    "maxvals": torch.ones(n, 4, 2), "heatmaps": torch.zeros(n, 4, 1, 1, 2)}

        cfg = default_config()
        perf, names, preds, maps = tloop.validate(cfg, _Loader(), _Dataset(), eval_step, None,
                                                  place_fn=place, device="cpu")
        assert placed == [3, 3, 3]  # the last batch padded by wrapping around
        assert perf == 7 * 4 and preds.shape == (28, 2, 3) and maps.shape == (28, 2, 1, 1)
        np.testing.assert_array_equal(preds[-4:, 0, 0], [2, 2, 2, 2])
    else:
        out = tloop.eval_prepare(default_config(), _Loader().batches[0], place_fn=place,
                                 prepare=prepare)
        assert placed == [3] and out["placed"].tolist() == [1.0, 1.0, 1.0]


def test_pad_host_batch_and_eval_prepare_match_jax(rng):
    batch = {"images": rng.randint(0, 255, (3, 4, 8, 8, 3)).astype(np.uint8),
             "is_h36m": np.float32([1, 0, 1])}
    got, ref = tloop._pad_host_batch(batch, 8), jloop._pad_host_batch(batch, 8)
    for k in batch:
        np.testing.assert_array_equal(got[k], ref[k])
    cfg = default_config()
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([8, 8]), np.array([4, 4])
    host = {"images": batch["images"], "joints_crop": rng.uniform(0, 8, (3, 4, 16, 2)),
            "joints_vis": np.ones((3, 4, 16)), "supervise": np.float32([1, 0, 1]),
            "is_h36m": batch["is_h36m"], "center": np.zeros((3, 4, 2), np.float32),
            "scale": np.ones((3, 4, 2), np.float32)}
    out = tloop.eval_prepare(cfg, host, device="cpu")
    assert out["images"].shape == (3, 4, 8, 8, 3) and out["target"].shape == (3, 4, 4, 4, 16)
    assert out["weight"][1].sum() == 0


# ----------------------------------------------------------------- utils


def test_logger_layout_and_scalar_bytes_match_jax(tmp_path):
    out = []
    for mod, make, sub in ((jlogging, jax_config, "j"), (tlogging, default_config, "t")):
        cfg = make()
        cfg.OUTPUT_DIR, cfg.LOG_DIR = str(tmp_path / sub / "output"), str(tmp_path / sub / "log")
        logger, final, tb = mod.create_logger(cfg, "experiments/mpii/x/140e_32batch.yaml")
        logger.info("hello")
        w = mod.ScalarWriter(tb)
        for step, v in enumerate((0.5, 1e-7, 3.25)):
            w.add_scalar("train_loss", np.float32(v), step)
        w.close()
        out.append((os.path.relpath(final, tmp_path / sub), os.path.relpath(tb, tmp_path / sub),
                    open(os.path.join(tb, "scalars.jsonl"), "rb").read(), sorted(os.listdir(final))))
    (jf, jtb, jbytes, jfiles), (tf, ttb, tbytes, tfiles) = out
    assert tf == jf == os.path.join("output", "mixed_dataset", "multiview_pose_resnet_50",
                                    "140e_32batch")
    assert ttb == jtb and tbytes == jbytes and tfiles == jfiles
    assert open(tmp_path / "t" / tf / tfiles[0]).read().rstrip().endswith("hello")


def test_average_meter_matches_jax():
    jm, tm = jlogging.AverageMeter(), tlogging.AverageMeter()
    for v, n in ((1.5, 4), (torch.tensor(0.25), 8), (np.float32(3.0), 1)):
        jm.update(float(v), n)
        tm.update(v, n)
        assert (tm.val, tm.avg, tm.sum, tm.count) == (jm.val, jm.avg, jm.sum, jm.count)


def test_batch_shape_and_finite_guards_match_jax(monkeypatch):
    good = {"images": np.zeros((2, 4, 8, 8, 3)), "target": np.zeros((2, 4, 4, 4, 16)),
            "weight": np.zeros((2, 4, 16)), "is_h36m": np.zeros(2),
            "center": np.zeros((2, 4, 2)), "scale": np.zeros((2, 4, 2))}
    tchecks.assert_batch_shapes({k: torch.from_numpy(v) for k, v in good.items()})
    for bad in ({k: v for k, v in good.items() if k != "scale"},
                {**good, "weight": np.zeros((2, 4, 15))}):
        with pytest.raises(ValueError) as je:
            jchecks.assert_batch_shapes(bad)
        with pytest.raises(ValueError) as te:
            tchecks.assert_batch_shapes(bad)
        assert str(te.value) == str(je.value)
    metrics = {"loss": torch.tensor(float("nan")), "acc": torch.tensor(0.5)}
    monkeypatch.setenv("POSETPU_CHECK_FINITE", "0")
    tchecks.check_finite_metrics(metrics, 3)
    monkeypatch.setenv("POSETPU_CHECK_FINITE", "1")
    with pytest.raises(FloatingPointError, match="'loss' at step 3"):
        tchecks.check_finite_metrics(metrics, 3)
    with pytest.raises(FloatingPointError, match="'loss' at step 3"):
        jchecks.check_finite_metrics({"loss": jnp.float32(np.nan)}, 3)


def test_step_timer_and_trace(tmp_path):
    timer = tprof.StepTimer()
    for _ in range(3):
        timer.data_ready()
        timer.step_done(torch.ones(2))
    s = timer.summary(samples_per_step=8)
    assert {"step_ms", "samples_per_s", "data_ms"} <= set(s) and s["samples_per_s"] > 0
    assert tprof.sync(torch.arange(4.0)) == 6.0
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
