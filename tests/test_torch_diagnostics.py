"""cli/diagnostics.py against the JAX package's on the CPU, on the image
fixture's H36M validation set (data/synthetic.write_image_fixture,
experiments/mixed/resnet50/256_nofusion_fund5.yaml) and a heatmap H5 dump
written from its GT joints: 16x16 Gaussian maps at the crop positions, the
locations the GT with 2 px of noise and one view of every fourth joint
moved 40 px, confidences drawn in (0.3, 1):

- ``ransac-report``: RANSAC's kept share equal, each CDF share within one
  joint's share (a reprojection error at the threshold may round either
  way in f32), the mean error within 0.5 mm;
- ``fund-residual`` on the dump and on the GT: within rtol 1e-6 (both
  numpy in float64 but for the F bank's f32);
- ``integral-check``: each PCKh within one joint's share (JAX nudges a
  map whose maximum is <= 0; the port decodes it as the reference);
- each subcommand through ``main`` and the H5 reader, and the array bodies
  (what chip_smoke.py drives on the card) equal to the file readers.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from posetpu.cli import diagnostics as jdiag
from posetpu.config import load_config as jload_config
from posetpu_torch.cli import diagnostics as tdiag
from posetpu_torch.config import load_config as tload_config
from posetpu_torch.data.base import sorted_union_indices
from posetpu_torch.data.h5io import save_heatmaps
from posetpu_torch.data.registry import get_dataset
from posetpu_torch.data.synthetic import write_image_fixture
from posetpu_torch.ops.affine import affine_transform_points, get_affine_transform
from posetpu_torch.ops.heatmap import render_gaussian_heatmaps

PRESET = "experiments/mixed/resnet50/256_nofusion_fund5.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """(fixture root, the H5 dump's path, the number of union joints)."""
    root = tmp_path_factory.mktemp("diagnostics") / "data"  # the preset's ROOT under --dataDir
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=4, h36m_train_groups=2, h36m_valid_groups=6,
                        seed=11)
    cfg = tload_config(os.path.join(REPO, PRESET))
    cfg.DATASET.ROOT = str(root)
    ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, cfg.DATASET.TEST_SUBSET, False)
    u = sorted_union_indices(ds.u2a_mapping)
    gt = ds.gt_joints_flat()[0][:, u]
    rs = np.random.RandomState(3)
    pred = gt + rs.randn(*gt.shape).astype(np.float32) * 2.0
    g = len(gt) // 4
    moved = pred.reshape(g, 4, -1, 2)
    moved[:, 1, ::4] += 40.0
    conf = rs.uniform(0.3, 1.0, gt.shape[:2]).astype(np.float32)
    flat = [i for items in ds.grouping for i in items]
    center = torch.from_numpy(np.array([ds.db[i]["center"] for i in flat], np.float32))
    scale = torch.from_numpy(np.array([ds.db[i]["scale"] for i in flat], np.float32))
    crop = affine_transform_points(torch.from_numpy(pred),
                                   get_affine_transform(center, scale, 0.0, (64, 64)))
    maps, _ = render_gaussian_heatmaps(crop, torch.ones(crop.shape[:2]), (16, 16), (64, 64),
                                       sigma=2.0)
    maps = maps * torch.from_numpy(conf)[..., None, None]
    path = str(root / "heatmaps_locations_validation_multiview_h36m.h5")
    save_heatmaps(path, maps.numpy(), np.concatenate([pred, conf[..., None]], -1), u)
    return root, path, len(u)


def _cfgs(root):
    out = []
    for load in (jload_config, tload_config):
        c = load(os.path.join(REPO, PRESET))
        c.DATASET.ROOT = str(root)
        c.PSEUDO_LABEL.CONFIDENCE_THRE = 0.5
        out.append(c)
    return out


def _quiet(*_):
    pass


def test_ransac_report_matches_jax(dump):
    root, path, nj = dump
    jcfg, tcfg = _cfgs(root)
    ref = jdiag.ransac_report(jcfg, path, log=_quiet)
    got = tdiag.ransac_report(tcfg, path, log=_quiet, device="cpu")
    assert list(got) == list(ref)
    assert got["kept_frac"] == ref["kept_frac"] and 0 < got["kept_frac"] < 1
    kept = ref["kept_frac"] * (len(tdiag._dataset(tcfg).grouping) * nj)
    for k, r in ref.items():
        if k.startswith("<="):
            assert abs(got[k] - r) <= 1.0 / kept + 1e-12, (k, got[k], r)
    assert abs(got["mean_mm"] - ref["mean_mm"]) <= 0.5


@pytest.mark.parametrize("from_dump", [True, False])
def test_fund_residual_matches_jax(dump, from_dump):
    root, path, _ = dump
    jcfg, tcfg = _cfgs(root)
    h5 = path if from_dump else ""
    ref = jdiag.fund_residual(jcfg, h5, log=_quiet)
    got = tdiag.fund_residual(tcfg, h5, log=_quiet)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert got["max"] > (1.0 if from_dump else 0.0)


def test_integral_check_matches_jax(dump):
    root, path, nj = dump
    jcfg, tcfg = _cfgs(root)
    ref = jdiag.integral_check(jcfg, path, log=_quiet)
    got = tdiag.integral_check(tcfg, path, log=_quiet, device="cpu")
    joints = len(tdiag._dataset(tcfg).grouping) * 4 * nj
    assert list(got) == list(ref) == ["argmax", "integral"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1.0 / joints + 1e-9, (k, got[k], ref[k])
    assert got["argmax"] > 0.5


def test_main_and_the_array_bodies(dump):
    from posetpu_torch.data.h5io import load_heatmaps

    root, path, _ = dump
    _, tcfg = _cfgs(root)
    heatmaps, locations, _ = load_heatmaps(path)
    ds = tdiag._dataset(tcfg)
    assert tdiag.integral_check_arrays(ds, heatmaps, _quiet, "cpu") == tdiag.integral_check(
        tcfg, path, log=_quiet, device="cpu")
    assert tdiag.fund_residual_arrays(ds, locations[:, :, :2], _quiet) == tdiag.fund_residual(
        tcfg, path, log=_quiet)
    base = ["--cfg", os.path.join(REPO, PRESET), "--dataDir", str(root.parent), "--heatmap",
            path]
    tcfg_main = tdiag.main(["integral-check", *base], device="cpu")
    assert set(tcfg_main) == {"argmax", "integral"}
    assert set(tdiag.main(["fund-residual", *base])) == {"mean", "max"}
    assert "kept_frac" in tdiag.main(["ransac-report", *base], device="cpu")
