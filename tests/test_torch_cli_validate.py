"""The port's validate and convert CLIs (cli/validate.py, cli/convert.py) on
the CPU, on the synthetic image fixture (data/synthetic.write_image_fixture)
with experiments/mixed/resnet50/256_fusion.yaml cut to ResNet-18 at 64x64 /
16x16 (the bank at S = 256, fuse routing on, validation on H36M):

- the arguments are the JAX CLIs';
- the float run (bf16 and f32) and the int8 runs (PTQ with ``--int8-act4
  l12 --int8-subpixel deconv0``, QAT with ``--qat-steps 2``) finish, with
  the H5 dump; the int8 run's preds are those of build_quant_from_variables
  + make_quant_eval_step through train/loop.validate on the same
  calibration batches; ``--qat-steps`` with ``--int8-subpixel`` raises, and
  ``--int8-act4`` under QAT says it is not applied;
- ``--trainset`` dumps the training grouping (::5), whose rows
  cli.pseudo_labels reads (tests/test_integration.py:320 for the JAX CLI);
- ``cli.convert`` of a reference .pth.tar, then ``--state <out>``, gives
  the preds of ``--state <file>.pth.tar``."""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

from posetpu.cli import convert as jconvert
from posetpu.cli import validate as jvalidate
from posetpu_torch.cli import convert as tconvert
from posetpu_torch.cli import validate as tvalidate
from posetpu_torch.cli.common import build_model, load_cfg, load_model_variables
from posetpu_torch.data.h5io import load_heatmaps
from posetpu_torch.data.loader import GroupLoader
from posetpu_torch.data.prepare import make_prepare_fn
from posetpu_torch.data.registry import get_dataset
from posetpu_torch.data.synthetic import write_image_fixture
from posetpu_torch.train.checkpoint import CheckpointManager
from posetpu_torch.train.loop import validate
from posetpu_torch.train.serve import build_quant_from_variables, make_quant_eval_step
from tests.test_torch_convert_torch import envelope, multiview_state

PRESET = "experiments/mixed/resnet50/256_fusion.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this module runs: under a parallel test
    run, eight a process oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """H36M with 3 training groups (after ::5) and 3 validation groups
    (after ::64) at 120x120, and a port checkpoint of a ResNet-18
    MultiViewPose with the bank (seeded weights)."""
    root = tmp_path_factory.mktemp("validate")
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=4, h36m_train_groups=3, h36m_valid_groups=3,
                        seed=11)
    cfg = _cfg(_args(root), root)
    model = build_model(cfg, bf16=False, generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    CheckpointManager(str(root / "ckpt")).save(
        "final_state", {"base_model": {"params": {k: v for k, v in sd.items() if k not in stats},
                                       "batch_stats": stats}})
    return root


def _args(root, *extra):
    return tvalidate.parse_args(["--cfg", os.path.join(REPO, PRESET), "--modelDir",
                                 str(root / "output"), "--logDir", str(root / "log"),
                                 "--state", str(root / "ckpt" / "final_state"), *extra])


def _cfg(args, root):
    cfg = load_cfg(args)
    cfg.DATASET.ROOT = str(root)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TEST.BATCH_SIZE = 2
    cfg.WORKERS = 1
    return cfg


def _quiet():
    log = logging.getLogger("test_torch_cli_validate")
    log.propagate = False
    return log


def _run(data, *extra, **kw):
    args = _args(data, *extra)
    return tvalidate.run(_cfg(args, data), args, device="cpu", log=_quiet(), **kw)


@pytest.mark.parametrize("argv", [
    ["--cfg", "x.yaml"],
    ["--cfg", "x.yaml", "--state", "s.pth.tar", "--flip-test", "--post-process",
     "--shift-heatmap", "--trainset", "--no-distortion", "--f32", "--int8",
     "--calib-batches", "3", "--qat-steps", "4", "--qat-lr", "1e-5", "--int8-act4", "l12",
     "--int8-subpixel", "deconv0", "--modelDir", "m", "--logDir", "l", "--dataDir", "d"],
])
def test_parse_args_match_jax(monkeypatch, argv):
    """The JAX package's flags, and the process-group flags the port adds
    (one process a GPU; JAX's validate spans its local devices without
    them), at their defaults."""
    monkeypatch.setattr("sys.argv", ["validate", *argv])
    got = vars(tvalidate.parse_args(argv))
    group = {k: got.pop(k) for k in ("coordinator", "num_processes", "process_id")}
    assert got == vars(jvalidate.parse_args())
    assert group == {"coordinator": "", "num_processes": 0, "process_id": 0}
    conv = ["--cfg", "x.yaml", "--torch", "a.pth.tar", "--out", "o"]
    monkeypatch.setattr("sys.argv", ["convert", *conv])
    assert vars(tconvert.parse_args(conv)) == vars(jconvert.parse_args())


def test_act4_names():
    assert tvalidate.act4_names("l12") == ("layer1_0.out", "layer1_1.out", "layer1_2.out",
                                           "layer2_0.out", "layer2_1.out", "layer2_2.out",
                                           "layer2_3.out")
    assert tvalidate.act4_names("layer1_0.out,,stem.out") == ("layer1_0.out", "stem.out")
    assert tvalidate.act4_names("") == ()


@pytest.mark.parametrize("extra", [[], ["--f32", "--flip-test"]], ids=["bf16", "f32_flip"])
def test_float_run_finishes_with_the_dump(data, extra):
    perf, names, preds, heatmaps = _run(data, *extra)
    assert preds.shape == (3 * 4, 16, 3) and heatmaps.shape == (3 * 4, 16, 16, 16)
    assert np.isfinite(preds).all() and 0 <= perf <= 1 and list(names)
    dumps = [os.path.join(b, n) for b, _, ns in os.walk(data / "output") for n in ns
             if n == "heatmaps_locations_validation_multiview_h36m.h5"]
    assert dumps
    _, loc, _ = load_heatmaps(dumps[0])
    assert loc.shape[0] == 3 * 4


def _direct_int8(data, act4, subpixel, qat_steps=0):
    """build_quant_from_variables + make_quant_eval_step through the loop's
    validate, on the CLI's calibration batches (the first two, prepared)."""
    args = _args(data, "--int8")
    cfg = _cfg(args, data)
    cfg.LOSS.USE_FUNDAMENTAL_LOSS = False
    ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, cfg.DATASET.TEST_SUBSET, False)
    loader = GroupLoader(ds, 2, shuffle=False, drop_last=False, num_threads=1)
    prep = make_prepare_fn(cfg, "cpu")
    it = iter(loader)
    calib = [prep(next(it))["images"].reshape(-1, 64, 64, 3) for _ in range(2)]
    it.close()
    qat = [calib[i % 2] for i in range(qat_steps)] or None
    variables = load_model_variables(args.state)
    qparams, qfwd, bank = build_quant_from_variables(cfg, variables, calib, qat_batches=qat,
                                                     subpixel_deconvs=subpixel, act4=act4,
                                                     device="cpu")
    assert bank is not None
    step = make_quant_eval_step(qfwd, cfg, flip_pairs=ds.flip_pairs, has_aggre=True,
                                device="cpu")
    return validate(cfg, loader, ds, step, {"q": qparams, "bank": bank}, device="cpu")


def test_int8_ptq_run_equals_the_composed_eval_step(data):
    got = _run(data, "--int8", "--int8-act4", "l12", "--int8-subpixel", "deconv0")
    ref = _direct_int8(data, tvalidate.act4_names("l12"), {"deconv0"})
    assert got[2].shape == (12, 16, 3) and np.isfinite(got[2]).all()
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[0] == ref[0]


def test_int8_qat_run_finishes_without_act4(data, caplog):
    log = logging.getLogger("validate_qat_check")
    args = _args(data, "--int8", "--qat-steps", "2", "--int8-act4", "l12")
    with caplog.at_level(logging.INFO, logger=log.name):
        got = tvalidate.run(_cfg(args, data), args, device="cpu", log=log)
    assert any("act4 is not applied under QAT" in r.message for r in caplog.records)
    ref = _direct_int8(data, (), False, qat_steps=2)
    np.testing.assert_array_equal(got[2], ref[2])


def test_int8_qat_refuses_subpixel(data):
    with pytest.raises(ValueError, match="PTQ-only"):
        _run(data, "--int8", "--qat-steps", "1", "--int8-subpixel", "deconv0")


def test_trainset_dumps_the_training_grouping(data):
    args = _args(data, "--trainset")
    cfg = _cfg(args, data)
    cfg.NETWORK.AGGRE = False
    _, _, preds, _ = tvalidate.run(cfg, args, device="cpu", log=_quiet())
    train = get_dataset("multiview_h36m")(cfg, "train", True)
    assert len(train.grouping) == 3 and preds.shape[0] == 3 * 4
    dumps = [os.path.join(b, n) for b, _, ns in os.walk(data / "output") for n in ns
             if n.startswith("heatmaps_locations_train")]
    assert dumps
    _, loc, _ = load_heatmaps(dumps[0])
    assert len(loc) == len(train.grouping) * 4


def test_convert_then_validate_equals_the_reference_file(data, tmp_path, capsys):
    ref_file = str(tmp_path / "final_state.pth.tar")
    torch.save(envelope(multiview_state(18, 9), "module"), ref_file)
    conv = tconvert.parse_args(["--cfg", os.path.join(REPO, PRESET), "--torch", ref_file,
                                "--out", str(tmp_path / "converted" / "model")])
    path = tconvert.run(_cfg(_args(data), data), conv)
    assert path == str(tmp_path / "converted" / "model.pt") and os.path.isfile(path)
    assert "M params" in capsys.readouterr().out
    from_file = _run(data, "--state", ref_file)
    from_pt = _run(data, "--state", str(tmp_path / "converted" / "model"))
    np.testing.assert_array_equal(from_pt[2], from_file[2])
    np.testing.assert_array_equal(from_pt[3], from_file[3])
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"base_model"} and "aggre_layer.weight" in saved["base_model"]["params"]


def test_validate_refuses_a_missing_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = _args(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvalidate.run(_cfg(args, data), args)
