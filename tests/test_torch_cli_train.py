"""The port's train CLI (cli/train.py) and cli/common.py's ``build_model``
and ``load_model_variables`` on the CPU, on a small image fixture
(data/synthetic.write_image_fixture) with the repo's two presets cut to
ResNet-18 at 64x64 / 16x16:

- ``parse_args`` and ``build_fund_extra`` against the JAX package's;
- ``run(device="cpu")`` on experiments/mpii/resnet50/140e_32batch.yaml:
  one epoch, the output layout of the JAX CLI, ``final_state``; then
  experiments/mixed/resnet50/256_nofusion_fund5.yaml warm-started from it
  through ``RESUME_PATH`` (the weights are the checkpoint's) and resumed
  through ``ON_SERVER_CLUSTER`` (the epoch and every state are the
  checkpoint's);
- the adversarial switch; the flags and checkpoint formats that raise."""

from __future__ import annotations

import argparse
import logging
import os
import signal

import numpy as np
import pytest
import torch

from posetpu.cli import train as jcli
from posetpu.config import load_config as jax_load_config
from posetpu.data import registry as jregistry
from posetpu_torch.cli import train as tcli
from posetpu_torch.cli.common import build_model, load_cfg, load_model_variables
from posetpu_torch.data import registry as tregistry
from posetpu_torch.train.checkpoint import CheckpointManager
from posetpu_torch.data.synthetic import write_image_fixture

MPII = "experiments/mpii/resnet50/140e_32batch.yaml"
MIXED = "experiments/mixed/resnet50/256_nofusion_fund5.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this module trains: under a parallel test
    run, eight a process oversubscribe the cores and each step waits on
    its slowest thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """MPII (2 train groups, 2 validation) and H36M (2 train groups, 1
    validation) at 96x72 / 120x120, and the COCO file."""
    root = tmp_path_factory.mktemp("cli")
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=8, mpii_valid=8, h36m_train_groups=2, h36m_valid_groups=1,
                        seed=5)
    return root


def _args(tmp_path, preset, *extra):
    return tcli.parse_args(["--cfg", os.path.join(REPO, preset), "--modelDir",
                            str(tmp_path / "output"), "--logDir", str(tmp_path / "log"),
                            *extra])


def _cfg(args, data, **over):
    """The preset, cut to ResNet-18 at 64x64 with 2 groups a batch."""
    cfg = load_cfg(args)
    cfg.DATASET.ROOT = str(data)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.DEBUG.DEBUG = False
    cfg.WORKERS = 1
    for k, v in over.items():
        sec, key = k.split(".")
        setattr(getattr(cfg, sec), key, v)
    return cfg


def _quiet():
    log = logging.getLogger("test_torch_cli_train")
    log.propagate = False
    return log


def _weights(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("argv", [
    ["--cfg", "x.yaml"],
    ["--cfg", "x.yaml", "--pseudo-path", "p.h5", "--no-distortion", "--epochs", "3",
     "--batch", "16", "--f32", "--modelDir", "m", "--logDir", "l", "--dataDir", "d"],
])
def test_parse_args_matches_jax(monkeypatch, argv):
    monkeypatch.setattr("sys.argv", ["train", *argv])
    assert vars(tcli.parse_args(argv)) == vars(jcli.parse_args())


def test_build_fund_extra_matches_jax(data, monkeypatch):
    monkeypatch.setenv("POSETPU_NATIVE_LOADER", "0")
    jcfg = jax_load_config(os.path.join(REPO, MIXED))
    tcfg = load_cfg(argparse.Namespace(cfg=os.path.join(REPO, MIXED), modelDir="", logDir="",
                                       dataDir=""))
    jcfg.DATASET.ROOT = tcfg.DATASET.ROOT = str(data)
    jds = jregistry.get_dataset("mixed")(jcfg, "train", True)
    tds = tregistry.get_dataset("mixed")(tcfg, "train", True)
    host = {"subject": np.int32([5, -1, 1, 5])}
    ref = np.asarray(jcli.build_fund_extra(jcfg, jds)(host, {})["fmats"])
    got = tcli.build_fund_extra(tcfg, tds, "cpu")(host, {})["fmats"]
    assert got.shape == (4, 12, 3, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bf16", [True, False])
def test_build_model(bf16):
    from posetpu_torch.config import default_config

    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.HEATMAP_SIZE = np.array([16, 16])
    a = build_model(cfg, bf16, torch.Generator().manual_seed(1))
    b = build_model(cfg, bf16, torch.Generator().manual_seed(1))
    assert a.resnet.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert a.aggre_layer is not None
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    cfg.NETWORK.AGGRE = False
    assert build_model(cfg, bf16).aggre_layer is None


def test_run_trains_an_epoch_then_warm_starts_and_resumes(data, tmp_path):
    """MPII pretraining, then the mixed retrain from its final_state, then
    the same retrain resumed from its own last checkpoint."""
    # step 1: the MPII preset (flip test, MPII augmentation)
    args = _args(tmp_path, MPII)
    tr1 = tcli.run(_cfg(args, data), args, device="cpu", log=_quiet())
    out1 = tmp_path / "output" / "mpii" / "multiview_pose_resnet_18" / "140e_32batch"
    assert tr1.output_dir == str(out1) and not tr1.adversarial
    for name in ("final_state.pt", "checkpoint.pt", "model_best.pt",
                 "heatmaps_locations_valid_mpii.h5"):
        assert (out1 / name).exists(), name
    assert tr1.base.step == len(tr1.train_loader) > 0
    final = CheckpointManager(str(out1)).restore_model()["base_model"]
    sd1 = tr1.base.params.state_dict()
    assert all(torch.equal(v.cpu(), sd1[k].cpu()) for k, v in final["params"].items())

    # step 2: the mixed preset, warm-started from step 1 (RESUME: true there)
    args = _args(tmp_path, MIXED)
    cfg = _cfg(args, data, **{"TRAIN.RESUME_PATH": str(out1 / "final_state")})
    tr2 = tcli.setup(cfg, args, device="cpu", log=_quiet())
    assert cfg.TRAIN.RESUME and tr2.extra is not None and tr2.base.step == 0
    got = tr2.base.params.state_dict()
    for part in ("params", "batch_stats"):
        for k, v in final[part].items():
            assert torch.equal(got[k], v), k
    tcli.train_epochs(tr2, tr2.output_dir)
    tr2.writer.close()
    out2 = tmp_path / "output" / "mixed" / "multiview_pose_resnet_18" / "256_nofusion_fund5"
    assert (out2 / "final_state.pt").exists()
    assert (out2 / "heatmaps_locations_validation_multiview_h36m.h5").exists()
    after = _weights(tr2.base.params)

    # step 3: ON_SERVER_CLUSTER resumes the run from its checkpoint (epoch 1)
    cfg = _cfg(args, data, **{"TRAIN.RESUME": False, "TRAIN.ON_SERVER_CLUSTER": True,
                              "TRAIN.END_EPOCH": 2})
    tr3 = tcli.setup(cfg, args, device="cpu", log=_quiet())
    assert tr3.begin_epoch == 1 and tr3.base.step == tr2.base.step
    assert tr3.base.opt_state["count"] == tr2.base.opt_state["count"] > 0
    now = tr3.base.params.state_dict()
    assert all(torch.equal(now[k], v) for k, v in after.items())
    tr3.writer.close()


def test_adversarial_losses_switch_to_the_adversarial_step(data, tmp_path):
    args = _args(tmp_path, MIXED)
    cfg = _cfg(args, data, **{"TRAIN.RESUME": False, "LOSS.USE_DOMAIN_TRANSFER_LOSS": True,
                              "LOSS.DOMAIN_LOSS_WEIGHT": 0.01})
    tr = tcli.setup(cfg, args, device="cpu", log=_quiet())
    assert tr.adversarial and set(tr.states()) == {"base_model", "domain_discriminator"}
    tr.train_loader.dataset.grouping = tr.train_loader.dataset.grouping[-2:]
    tcli.train_epochs(tr, None)
    tr.writer.close()
    saved = CheckpointManager(tr.output_dir).restore("final_state")[0]
    assert set(saved) == {"base_model", "domain_discriminator"}
    assert all(st.step == 1 for st in tr.states().values())


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"]])
def test_several_processes_raise_naming_a6(data, tmp_path, flag):
    args = _args(tmp_path, MPII, *flag)
    with pytest.raises(NotImplementedError, match="A6"):
        tcli.setup(_cfg(args, data), args, device="cpu")


@pytest.mark.parametrize("kind", ["pth", "pth.tar", "orbax", "missing"])
def test_load_model_variables_refuses_other_formats(tmp_path, kind):
    if kind == "orbax":
        path = tmp_path / "final_state"
        (path / "_CHECKPOINT_METADATA").parent.mkdir()
        with pytest.raises(ValueError, match="Orbax"):
            load_model_variables(str(path))
    elif kind == "missing":
        with pytest.raises(FileNotFoundError):
            load_model_variables(str(tmp_path / "final_state"))
    else:  # a reference checkpoint is read through models/convert_torch.py, not refused
        w = torch.arange(6.0).reshape(1, 2, 1, 3)
        torch.save({"state_dict": {"module.conv1.weight": w, "module.fc.bias": torch.ones(2)}},
                   str(tmp_path / f"model.{kind}"))
        got = load_model_variables(str(tmp_path / f"model.{kind}"))
        assert set(got["params"]) == {"resnet.conv1.weight"} and not got["batch_stats"]
        assert torch.equal(got["params"]["resnet.conv1.weight"], w)


def test_load_model_variables_drops_the_bank(tmp_path):
    from posetpu_torch.config import default_config
    from posetpu_torch.train.optim import make_optimizer
    from posetpu_torch.train.step import init_train_state

    cfg = default_config()
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.NETWORK.HEATMAP_SIZE = np.array([8, 8])
    model = build_model(cfg, bf16=False, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, make_optimizer(cfg, 1), device="cpu")
    CheckpointManager(str(tmp_path)).save_final({"base_model": state})
    full = load_model_variables(str(tmp_path / "final_state.pt"))
    cut = load_model_variables(str(tmp_path / "final_state"), drop_aggre=True)
    assert "aggre_layer.weight" in full["params"] and "aggre_layer.weight" not in cut["params"]
    assert set(full["params"]) - set(cut["params"]) == {"aggre_layer.weight"}
    assert set(full["batch_stats"]) == set(state.batch_stats)


def test_run_restores_the_sigterm_handler(data, tmp_path):
    """run installs the exit-for-resume handler while it trains and puts
    the previous one back (the epoch loop replaced by a spy)."""
    seen = []
    args = _args(tmp_path, MPII)
    cfg = _cfg(args, data)
    before = signal.getsignal(signal.SIGTERM)
    orig = tcli.train_epochs

    def spy(tr, out):
        seen.append(signal.getsignal(signal.SIGTERM))
        return -1.0

    tcli.train_epochs = spy
    try:
        tcli.run(cfg, args, device="cpu", log=_quiet())
    finally:
        tcli.train_epochs = orig
    assert seen == [tcli._sigterm] and signal.getsignal(signal.SIGTERM) == before
    with pytest.raises(SystemExit) as e:
        tcli._sigterm(signal.SIGTERM, None)
    assert e.value.code == 143
