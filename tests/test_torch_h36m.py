"""The port's H36M annotation side (data/h36m.py, data/base.py,
data/registry.py) and its three 3D CLIs (cli/triangulate.py, cli/rpsm.py,
cli/pseudo_labels.py) against the JAX package on the CPU, on a synthetic
annotation pickle (17 joints, no images) that both packages read."""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.cli import rpsm as jcli_rpsm
from posetpu.cli import pseudo_labels as jcli_pseudo
from posetpu.cli import triangulate as jcli_tri
from posetpu.config import load_config as jload_config
from posetpu.data.h36m import MultiViewH36M as JH36M
from posetpu.data.synthetic import make_camera_ring, make_poses3d
from posetpu.geometry.cameras import project_points, world_to_camera_frame
from posetpu_torch.cli import common as tcommon
from posetpu_torch.cli import pseudo_labels as tcli_pseudo
from posetpu_torch.cli import rpsm as tcli_rpsm
from posetpu_torch.cli import triangulate as tcli_tri
from posetpu_torch.config import load_config as tload_config
from posetpu_torch.data import h5io as th5
from posetpu_torch.data.h36m import MultiViewH36M as TH36M
from posetpu_torch.data.registry import get_dataset
from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform
from posetpu_torch.ops.heatmap import render_gaussian_heatmaps

N_GROUPS = 11  # train ::5 -> groups 0, 5, 10; validation ::64 -> group 0


def _cam_dict(cams, v):
    return {"R": np.asarray(cams.R[v], np.float64), "T": np.asarray(cams.T[v], np.float64)
            .reshape(3, 1), "fx": float(cams.f[v, 0]), "fy": float(cams.f[v, 1]),
            "cx": float(cams.c[v, 0]), "cy": float(cams.c[v, 1]),
            "k": np.asarray(cams.k[v], np.float64).reshape(3, 1),
            "p": np.asarray(cams.p[v], np.float64).reshape(2, 1)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """data/h36m/annot/h36m_{train,validation}.pkl: 11 complete four-view
    groups and one with a view missing, records shuffled, some joints
    invisible; the crop box from the projected joints."""
    root = tmp_path_factory.mktemp("data")
    cams = make_camera_ring()
    pts3d = make_poses3d(N_GROUPS + 1, n_joints=17, seed=4) * np.float32([0.4, 0.4, 1.0])
    rs = np.random.RandomState(4)
    db = []
    for g in range(N_GROUPS + 1):
        for v in range(4 if g < N_GROUPS else 3):
            cam_v = jax.tree.map(lambda x, v=v: x[v], cams)
            pix = np.asarray(project_points(jnp.asarray(pts3d[g]), cam_v), np.float64)
            vis = np.ones((17, 3))
            vis[rs.rand(17) < 0.1] = 0.0
            lo, hi = pix.min(0), pix.max(0)
            db.append({
                "image": f"s_01_act_02_g{g}_c{v}.jpg",
                "center": (lo + hi) / 2.0,
                "scale": np.full(2, (hi - lo).max() * 1.25 / 200.0),
                "joints_2d": pix, "joints_vis": vis,
                "joints_3d": np.asarray(world_to_camera_frame(
                    jnp.asarray(pts3d[g]), cam_v.R, cam_v.T), np.float64),
                "camera": _cam_dict(cams, v), "source": "h36m", "subject": 1,
                "action": 2, "subaction": 1, "image_id": g, "camera_id": v})
    db = [db[i] for i in rs.permutation(len(db))]
    os.makedirs(root / "h36m" / "annot")
    for subset in ("train", "validation"):
        with open(root / "h36m" / "annot" / f"h36m_{subset}.pkl", "wb") as f:
            pickle.dump(db, f)
    return root


@pytest.fixture(scope="module")
def yaml_path(root, tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "synth_h36m.yaml"
    path.write_text(f"""OUTPUT_DIR: {root / 'out'}
DATASET:
  ROOT: {root}
  TEST_DATASET: multiview_h36m
  TEST_SUBSET: validation
NETWORK:
  IMAGE_SIZE: [256, 256]
  HEATMAP_SIZE: [64, 64]
PICT_STRUCT:
  FIRST_NBINS: 8
  RECUR_DEPTH: 2
""")
    return str(path)


@pytest.mark.parametrize("subset,is_train", [("train", True), ("validation", False)])
def test_dataset_matches_jax(yaml_path, subset, is_train):
    t = TH36M(tload_config(yaml_path), subset, is_train)
    j = JH36M(jload_config(yaml_path), subset, is_train)
    assert len(t) == len(j) == (3 if is_train else 1)
    assert t.grouping == j.grouping and t.u2a_mapping == j.u2a_mapping
    assert t.flip_pairs == j.flip_pairs and t.aug_param_dict == j.aug_param_dict
    for a, b in zip(t.db, j.db):
        assert all(np.array_equal(a[k], b[k]) for k in ("joints_2d", "joints_vis", "center"))
    for a, b in zip(t.cameras_flat(), j.cameras_flat()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for union in (True, False):
        for a, b in zip(t.gt_joints_flat(union), j.gt_joints_flat(union)):
            assert np.array_equal(a, b)
    pred = t.gt_joints_flat()[0] + np.random.RandomState(1).randn(len(t) * 4, 16, 2) * 8
    (t_values, t_mean), (j_values, j_mean) = t.evaluate(pred), j.evaluate(pred)
    assert t_values == j_values and t_mean == j_mean and 0 < t_mean < 1


def test_add_pseudo_matches_jax(yaml_path, tmp_path):
    rs = np.random.RandomState(2)
    path = str(tmp_path / "0.7_1_pseudo_label.h5")
    th5.save_pseudo_labels(path, rs.rand(12, 16, 2) * 900, rs.rand(12, 16) > 0.4)
    t = TH36M(tload_config(yaml_path), "train", True, pseudo_label_path=path)
    j = JH36M(jload_config(yaml_path), "train", True, pseudo_label_path=path)
    assert t.pseudo_label and j.pseudo_label
    for a, b in zip(t.db, j.db):
        for k in ("joints_2d_pseudo", "joints_vis_pseudo"):
            assert (k in a) == (k in b) and (k not in a or np.array_equal(a[k], b[k]))
    with pytest.raises(ValueError, match="rows"):
        th5.save_pseudo_labels(path, np.zeros((8, 16, 2)), np.zeros((8, 16)))
        TH36M(tload_config(yaml_path), "train", True, pseudo_label_path=path)


def test_what_is_not_ported_says_so(yaml_path, tmp_path):
    """Since the image data layer was ported, every name of the JAX
    package's registry is served and ``evaluate(output_dir=...)`` draws:
    here, with no images on disk, it writes the JSON-lines summary and then
    raises FileNotFoundError naming the first image, as JAX's does."""
    ds = get_dataset("multiview_h36m")(tload_config(yaml_path), "validation", False)
    with pytest.raises(FileNotFoundError, match=r"h36m/images/s_01_act_02_g\d+_c\d.jpg"):
        ds.evaluate(ds.gt_joints_flat(union=False)[0], output_dir=str(tmp_path))
    assert (tmp_path / "all_preds_h36m.jsonl").exists()
    for name in ("mpii", "mixed", "coco", "coco_mpii"):
        assert get_dataset(name).__name__.endswith("Dataset")
    with pytest.raises(KeyError):
        get_dataset("no such data set")


def _heatmap_h5(yaml_path, path, subset, is_train):
    """A heatmap dump over the grouping: maps rendered at the GT joints'
    crops, locations the GT joints with 3 px noise, one view of a fifth of
    the joints 80 px off, confidences U(0.5, 1)."""
    ds = TH36M(tload_config(yaml_path), subset, is_train)
    gt, _ = ds.gt_joints_flat()
    flat = [i for items in ds.grouping for i in items]
    center = np.array([ds.db[i]["center"] for i in flat], np.float32)
    scale = np.array([ds.db[i]["scale"] for i in flat], np.float32)
    crop = affine_transform_points(torch.from_numpy(gt), get_affine_transform(
        torch.from_numpy(center), torch.from_numpy(scale), 0.0, (256, 256)))
    hm, _ = render_gaussian_heatmaps(crop, torch.ones(gt.shape[:2]), (64, 64), (256, 256), 2)
    rs = np.random.RandomState(5)
    loc = gt + rs.randn(*gt.shape).astype(np.float32) * 3
    out = rs.rand(len(gt) // 4, 16) < 0.2
    g_, j_ = np.nonzero(out)
    loc[g_ * 4 + rs.randint(0, 4, len(g_)), j_] += 80.0
    conf = rs.uniform(0.5, 1.0, gt.shape[:2]).astype(np.float32)
    th5.save_heatmaps(path, hm.numpy(), np.concatenate([loc, conf[..., None]], -1),
                      np.arange(16))
    return path


def test_cli_triangulate_matches_jax(yaml_path, tmp_path):
    """On GT (the oracle, < 1 mm): mean, std and max within 1e-3 mm of
    JAX's (the errors are rounding noise, so is the share above mean + std:
    not compared). On a validation heatmap dump: all four stats, the share
    equal."""
    quiet = lambda *_: None
    t = tcli_tri.run(tload_config(yaml_path), log=quiet, device="cpu")
    j = jcli_tri.run(jload_config(yaml_path), log=quiet)
    assert t["mean_mm"] < 1.0
    assert all(abs(t[k] - j[k]) <= 1e-3 for k in ("mean_mm", "std_mm", "max_mm")), (t, j)
    h5 = _heatmap_h5(yaml_path, str(tmp_path / "val.h5"), "validation", False)
    t = tcli_tri.run(tload_config(yaml_path), h5, log=quiet, device="cpu")
    j = jcli_tri.run(jload_config(yaml_path), h5, log=quiet)
    assert t["mean_mm"] > 1.0 and t["tail_frac"] == j["tail_frac"]
    assert all(abs(t[k] - j[k]) <= 1e-3 for k in ("mean_mm", "std_mm", "max_mm")), (t, j)


def test_cli_rpsm_and_pseudo_labels_match_jax(yaml_path, tmp_path, monkeypatch):
    """One training-grouping heatmap dump, written once. RPSM on its first
    group (8 bins, depth 2): MPJPE within 1e-3 mm of JAX's. Pseudo labels
    with --ransac --inliers 3 --reproj-thre 10 --use-reproj: the same files,
    lists, labels (within 1e-3 px), visibilities and entries; JAX's through
    its ``main``."""
    h5 = _heatmap_h5(yaml_path, str(tmp_path / "train.h5"), "train", True)
    quiet = lambda *_: None
    t = tcli_rpsm.run(tload_config(yaml_path), h5, max_groups=1, log=quiet, device="cpu")
    j = jcli_rpsm.run(jload_config(yaml_path), h5, max_groups=1, log=quiet)
    assert abs(t["mpjpe_mm"] - j["mpjpe_mm"]) <= 1e-3 and abs(t["max_mm"] - j["max_mm"]) <= 1e-3

    flags = ["--heatmap", h5, "--ransac", "--inliers", "3", "--reproj-thre", "10", "--use-reproj"]
    monkeypatch.setattr(sys, "argv", ["pseudo_labels", "--cfg", yaml_path,
                                      "--modelDir", str(tmp_path / "j")] + flags)
    monkeypatch.setattr("builtins.print", quiet)
    want = jcli_pseudo.main()
    args = argparse.Namespace(cfg=yaml_path, modelDir=str(tmp_path / "t"), logDir="", dataDir="")
    got = tcli_pseudo.run(tcommon.load_cfg(args), h5, yaml_path, ransac=True, inliers=3,
                          reproj_thre=10.0, use_reproj=True, log=quiet, device="cpu")
    dirs = [str(tmp_path / side / "test" / "synth_h36m" / "3_10.0") for side in "tj"]
    listings = [sorted(os.listdir(d)) for d in dirs]
    assert listings[0] == listings[1] and len(listings[0]) == 10
    for name in listings[0]:
        a, b = (os.path.join(d, name) for d in dirs)
        if name.endswith(".txt"):
            rel = lambda p, d: [os.path.relpath(x, d) for x in open(p).read().split()]
            assert rel(a, dirs[0]) == rel(b, dirs[1])
        else:
            (pa, va), (pb, vb) = th5.load_pseudo_labels(a), th5.load_pseudo_labels(b)
            assert np.abs(pa - pb).max() <= 1e-3 and np.array_equal(va, vb), name
    for a, b in zip(got["entries"], want["entries"]):
        assert a["tag"] == b["tag"] and a["vis"] == b["vis"] and abs(a["pckh"] - b["pckh"]) <= 1e-6
    assert got["selected"] == want["selected"] and got["choose"]() == want["choose"]()
