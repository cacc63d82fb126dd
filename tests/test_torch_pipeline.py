"""cli/pipeline.py (the self-training loop) on the CPU:

- with injected stages, against the JAX package's ``run_pipeline`` on the
  same arguments: tests/test_pipeline.py's cases (a run killed entering
  iteration 1 resumes there with iteration 0's pseudo labels and the
  fundamental loss on; a finished run resumes to nothing; ``--fresh``
  starts over), the stage calls, the result and the resume record equal;
- ``parse_args`` equal to JAX's;
- the default stages on a small image fixture
  (data/synthetic.write_image_fixture, experiments/mixed/resnet50/
  256_nofusion_fund5.yaml cut to ResNet-18 at 64x64, one epoch an
  iteration) for two iterations: each trains, dumps the train set's heatmap
  H5 and mints ``0.7_1_pseudo_label.h5``; iteration 1 reads iteration 0's
  labels and starts from iteration 0's ``final_state`` (the model; the
  optimizer fresh); a restart skips both finished iterations.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import pytest
import torch

from posetpu.cli import pipeline as jpipe
from posetpu.config import default_config as jax_config
from posetpu_torch.cli import pipeline as tpipe
from posetpu_torch.cli.common import load_cfg
from posetpu_torch.config import default_config
from posetpu_torch.data.synthetic import write_image_fixture

MIXED = "experiments/mixed/resnet50/256_nofusion_fund5.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(repeats=2, fresh=False):
    return argparse.Namespace(cfg="", repeats=repeats, fund=True, fresh=fresh, ransac=False,
                              inliers=3, reproj_thre=10.0, confidence_thre=0.7,
                              use_reproj=False, no_distortion=True, epochs=0)


def _stages(calls, die_at=None):
    def train_fn(cfg, pseudo_path, it):
        if die_at is not None and it == die_at:
            raise KeyboardInterrupt("simulated preemption")
        calls.append(("train", it, pseudo_path, bool(cfg.LOSS.USE_FUNDAMENTAL_LOSS)))
        return f"state_{it}"

    def validate_fn(cfg, state, it):
        calls.append(("validate", it, state))
        return f"heatmaps_{it}.h5"

    def mint_fn(cfg, heatmap_path, it):
        calls.append(("mint", it, heatmap_path))
        return f"pseudo_{it}.h5"

    return train_fn, validate_fn, mint_fn


def _both(tmp_path, script):
    """``script(run_pipeline, cfg, state_path)`` on the JAX package and on
    the port, each in its own output directory; returns both results."""
    out = []
    for name, mod, make in (("jax", jpipe, jax_config), ("port", tpipe, default_config)):
        cfg = make()
        cfg.OUTPUT_DIR = str(tmp_path / name)
        out.append(script(mod.run_pipeline, cfg,
                          lambda c, a, mod=mod: mod.pipeline_state_path(c, a)))
    return out


def test_resume_after_a_kill_matches_jax(tmp_path):
    def script(run, cfg, state_path):
        calls1, calls2 = [], []
        with pytest.raises(KeyboardInterrupt):
            run(cfg, _args(), *_stages(calls1, die_at=1), log=lambda *_: None)
        with open(state_path(cfg, _args())) as f:
            saved = json.load(f)
        result = run(cfg, _args(), *_stages(calls2), log=lambda *_: None)
        return calls1, saved, calls2, result

    ref, got = _both(tmp_path, script)
    assert got == ref
    calls1, saved, calls2, result = got
    assert saved == {"next_iteration": 1, "pseudo_path": "pseudo_0.h5"}
    assert calls2[0] == ("train", 1, "pseudo_0.h5", True) and result == "pseudo_1.h5"
    assert ("mint", 0, "heatmaps_0.h5") in calls1


def test_fresh_restarts_and_a_finished_run_resumes_to_nothing(tmp_path):
    def script(run, cfg, state_path):
        runs = []
        for fresh in (False, False, True):
            calls = []
            out = run(cfg, _args(fresh=fresh), *_stages(calls), log=lambda *_: None)
            runs.append((calls, out))
        return runs, os.path.relpath(state_path(cfg, _args()), cfg.OUTPUT_DIR)

    ref, got = _both(tmp_path, script)
    assert got == ref
    runs, rel = got
    assert [c[1] for c in runs[0][0] if c[0] == "train"] == [0, 1]
    assert runs[1][0] == [] and runs[1][1] == "pseudo_1.h5"
    assert [c[1] for c in runs[2][0] if c[0] == "train"] == [0, 1]
    assert [c[3] for c in runs[2][0] if c[0] == "train"] == [False, True]
    assert rel == os.path.join("mixed_dataset", "multiview_pose_resnet_50", "default",
                               "pipeline_state.json")


@pytest.mark.parametrize("argv", [
    ["--cfg", "x.yaml"],
    ["--cfg", "x.yaml", "--repeats", "3", "--ransac", "--inliers", "2", "--reproj-thre", "5",
     "--confidence-thre", "0.5", "--use-reproj", "--fund", "--no-distortion", "--epochs", "2",
     "--fresh", "--adaptive-thre", "--dataDir", "d"],
])
def test_parse_args_matches_jax(monkeypatch, argv):
    monkeypatch.setattr("sys.argv", ["pipeline", *argv])
    assert vars(tpipe.parse_args(argv)) == vars(jpipe.parse_args())


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_default_stages_two_iterations_warm_start_and_restart(tmp_path, monkeypatch):
    from posetpu_torch.train import loop
    from posetpu_torch.train.checkpoint import CheckpointManager

    data = tmp_path / "data"
    write_image_fixture(str(data), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=4, h36m_train_groups=2, h36m_valid_groups=1,
                        seed=5)
    args = tpipe.parse_args(["--cfg", os.path.join(REPO, MIXED), "--modelDir",
                             str(tmp_path / "output"), "--logDir", str(tmp_path / "log"),
                             "--epochs", "1", "--no-distortion"])
    args.no_distortion = False  # the fixture has no undistorted images
    cfg = load_cfg(args)
    cfg.DATASET.ROOT = str(data)
    cfg.NETWORK.IMAGE_SIZE, cfg.NETWORK.HEATMAP_SIZE = np.array([64, 64]), np.array([16, 16])
    cfg.POSE_RESNET.NUM_LAYERS = 18
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.DEBUG.DEBUG = False
    cfg.WORKERS = 1

    started, saved, train_epoch = [], [], loop.train_epoch

    def spy(cfg_, loader, prepare, step, state, epoch, **kw):
        """The weights each iteration starts from, and the final_state on
        disk at that moment."""
        started.append({k: v.clone() for k, v in state.params.state_dict().items()})
        found = list((tmp_path / "output").rglob("final_state.pt"))
        saved.append(CheckpointManager(str(found[0].parent)).restore_model()["base_model"]
                     if found else None)
        return train_epoch(cfg_, loader, prepare, step, state, epoch, **kw)

    monkeypatch.setattr(loop, "train_epoch", spy)
    logs = []
    out = tpipe.run_pipeline(cfg, args, log=logs.append, device="cpu")
    assert len(started) == 2 and os.path.basename(out) == "0.7_1_pseudo_label.h5"
    assert os.path.exists(out) and os.path.basename(os.path.dirname(out)) == "pseudo_it1"
    it_dir = os.path.dirname(os.path.dirname(out))
    assert os.path.exists(os.path.join(it_dir, "heatmaps_locations_train_multiview_h36m.h5"))
    assert os.path.exists(os.path.join(it_dir, "pseudo_it0", "0.7_1_pseudo_label.h5"))
    # iteration 1 started from iteration 0's final_state (iteration 0 moved
    # away from the seed's weights), not from the seed
    assert saved[0] is None and saved[1] is not None
    prev = {**saved[1]["params"], **saved[1]["batch_stats"]}
    assert all(torch.equal(started[1][k], v) for k, v in prev.items())
    assert not all(torch.equal(started[0][k], v) for k, v in prev.items())
    assert f"iteration 1: pseudo labels at {out}" in logs

    # a restart finds both iterations done
    again = tpipe.run_pipeline(cfg, args, log=logs.append, device="cpu")
    assert again == out and len(started) == 2
    assert any("iterations 0..1 already complete" in m for m in logs)
