"""cli/generate.py against the JAX package's on the CPU, on a small image
fixture (data/synthetic.write_image_fixture: H36M at 120x120, four-view
groups of two subjects, distortion on) read through
experiments/mixed/resnet50/256_nofusion_fund5.yaml:

- ``fundamental`` from the GT joints (each 8-point fit within
  tests/test_torch_mi.py's ``eight_point`` bound of JAX's, 1e-4 with the
  free sign taken out, or at most three times as far from the float64 fit
  as JAX's: both fit in f32 by the eigenvectors of A^T A, whose rounding
  moves an entry by up to 2e-4 here) and ``--from-calibration`` (equal);
- ``pairwise``: the limb lengths within 1e-4 mm relative (f32 world
  poses, averaged) and the tables equal, at 8^3 bins (the preset's 16^3
  tables are 64 MB an edge);
- ``undistort``: the records equal, the remapped images (before their
  JPEG encode) within 1 grey level (the remap's f32 sums round otherwise
  under XLA);
- ``pseudo-cfg``: the YAMLs equal;
- the command line: ``main`` with each subcommand's flags.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest

from posetpu.cli import generate as jgen
from posetpu.config import load_config as jload_config
from posetpu_torch.cli import generate as tgen
from posetpu_torch.config import load_config as tload_config
from posetpu_torch.data.synthetic import write_image_fixture

PRESET = "experiments/mixed/resnet50/256_nofusion_fund5.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("generate")
    write_image_fixture(str(root), n_images=8, mpii_size=(96, 72), h36m_size=(120, 120),
                        mpii_train=4, mpii_valid=4, h36m_train_groups=6, h36m_valid_groups=2,
                        seed=9)
    return root


def _cfgs(data, tmp_path):
    out = []
    for load in (jload_config, tload_config):
        c = load(os.path.join(REPO, PRESET))
        c.DATASET.ROOT = str(data)
        c.OUTPUT_DIR = str(tmp_path / "out")
        c.PICT_STRUCT.FIRST_NBINS = 8
        out.append(c)
    return out


def _quiet(*_):
    pass


def _fits64(cfg) -> dict:
    """The 8-point fits of every (subject, pair) in float64 (the port's
    estimator on the same GT joints; the held-out groups are all the
    fixture's, as with holdout=2 of 6)."""
    import torch

    from posetpu_torch.core.losses import VIEW_PERMS
    from posetpu_torch.data.base import sorted_union_indices
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.fundamental import eight_point

    ds = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, "train", True)
    pts = ds.gt_joints_flat()[0][:, sorted_union_indices(ds.u2a_mapping)]
    pts = pts.astype(np.float32).astype(np.float64).reshape(len(ds.grouping), 4, -1, 2)
    subj = [ds.db[items[0]]["subject"] for items in ds.grouping]
    out = {}
    for s in sorted(set(subj)):
        groups = [i for i, x in enumerate(subj) if x == s]
        fit = groups[:-2] or groups
        for a, b in VIEW_PERMS:
            out[(s, a, b)] = eight_point(torch.from_numpy(pts[fit, a].reshape(-1, 2)),
                                         torch.from_numpy(pts[fit, b].reshape(-1, 2))).numpy()
    return out


@pytest.mark.parametrize("calibration", [False, True])
def test_fundamental_matches_jax(data, tmp_path, calibration):
    jcfg, tcfg = _cfgs(data, tmp_path)
    ref = jgen.generate_fundamental(jcfg, str(tmp_path / "j.pkl"), calibration, holdout=2,
                                    log=_quiet)
    got = tgen.generate_fundamental(tcfg, str(tmp_path / "t.pkl"), calibration, holdout=2,
                                    log=_quiet, device="cpu")
    with open(tmp_path / "t.pkl", "rb") as f:
        assert set(pickle.load(f)) == set(got)
    if not calibration:
        fit64 = _fits64(tcfg)
    assert set(got) == set(ref) and len(got) == 24  # two subjects, 12 ordered pairs
    for k, r in ref.items():
        assert got[k].dtype == np.float32 and got[k].shape == (3, 3)
        if calibration:
            np.testing.assert_array_equal(got[k], r)
            continue
        # f32's eigh of A^T A moves either fit off the float64 one: the
        # port within 1e-4 of JAX (tests/test_torch_mi.py's bound) or at
        # most three times as far from the float64 fit as JAX is
        f64 = fit64[k]
        sg, sr = np.sign((got[k] * f64).sum()), np.sign((r * f64).sum())
        d_port = np.abs(sg * got[k] - f64).max()
        d_jax = np.abs(sr * r - f64).max()
        assert (np.abs(sg * got[k] - sr * r).max() <= 1e-4
                or d_port <= 3 * d_jax), (k, d_port, d_jax)


def test_pairwise_matches_jax(data, tmp_path):
    jcfg, tcfg = _cfgs(data, tmp_path)
    jl, jc = jgen.generate_pairwise(jcfg, str(tmp_path / "j"), log=_quiet)
    tl, tc = tgen.generate_pairwise(tcfg, str(tmp_path / "t"), log=_quiet, device="cpu")
    assert set(tl) == set(jl) and set(tc) == set(jc)
    for e in jl:
        np.testing.assert_allclose(tl[e], jl[e], rtol=1e-4)
    for e in jc:
        assert tc[e].shape == (512, 512)
        np.testing.assert_array_equal(tc[e], np.asarray(jc[e]))
    assert sorted(os.listdir(tmp_path / "t")) == ["limb_length.pkl", "pairwise_b8.pkl"]


def test_undistort_matches_jax(data, tmp_path, monkeypatch):
    import cv2

    written, imwrite = {}, cv2.imwrite

    def record(path, img):  # the remapped pixels before the JPEG encode
        written[os.path.relpath(path, tmp_path)] = img.copy()
        return imwrite(path, img)

    monkeypatch.setattr(cv2, "imwrite", record)
    jcfg, tcfg = _cfgs(data, tmp_path)
    jp = jgen.generate_undistorted(jcfg, str(tmp_path / "j"), max_groups=1, log=_quiet)
    tp = tgen.generate_undistorted(tcfg, str(tmp_path / "t"), max_groups=1, log=_quiet,
                                   device="cpu")
    assert os.path.relpath(tp, tmp_path / "t") == os.path.relpath(jp, tmp_path / "j")
    with open(jp, "rb") as f:
        ref = pickle.load(f)
    with open(tp, "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "camera":
                for c in r[k]:
                    np.testing.assert_array_equal(np.asarray(g[k][c]), np.asarray(r[k][c]))
            else:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]), err_msg=k)
        a = written[os.path.join("t", "h36m", "images", g["image"])].astype(int)
        b = written[os.path.join("j", "h36m", "images", r["image"])].astype(int)
        assert a.shape == b.shape == (120, 120, 3) and np.abs(a - b).max() <= 1
        assert a.std() > 5  # a real picture, not a blank
        assert os.path.exists(tmp_path / "t" / "h36m" / "images" / g["image"])


def test_undistort_image_without_distortion_is_identity(rng):
    from posetpu_torch.geometry.cameras import CameraParams
    import torch

    img = rng.randint(0, 255, (12, 10, 3)).astype(np.uint8)
    z = torch.zeros
    cam = CameraParams(torch.eye(3), z(3), torch.tensor([50.0, 50.0]),
                       torch.tensor([5.0, 6.0]), z(3), z(2))
    np.testing.assert_array_equal(tgen.undistort_image(img, cam, "cpu"), img)


def test_pseudo_cfg_matches_jax(tmp_path):
    sel = tmp_path / "select.txt"
    sel.write_text("out/3_10/0.7_1_pseudo_label.h5\n\nplain_pseudo_label.h5\n")
    base = os.path.join(REPO, PRESET)
    ref = jgen.generate_pseudo_cfg(base, str(sel), str(tmp_path / "j"), log=_quiet)
    got = tgen.generate_pseudo_cfg(base, str(sel), str(tmp_path / "t"), log=_quiet)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == [
        "pseudo_3_10_0.7_1.yaml", "pseudo_plain.yaml"]
    for g, r in zip(got, ref):
        assert open(g).read() == open(r).read()


def test_main_runs_each_subcommand(data, tmp_path, monkeypatch):
    cfg = os.path.join(REPO, PRESET)
    base = ["--cfg", cfg, "--dataDir", str(data)]
    # --dataDir joins the preset's relative ROOT: point it at the fixture
    monkeypatch.setattr(tgen, "generate_fundamental",
                        lambda c, out, cal, device=None: ("fundamental", out, cal, device))
    monkeypatch.setattr(tgen, "generate_pairwise",
                        lambda c, out, device=None: ("pairwise", out, device))
    monkeypatch.setattr(tgen, "generate_undistorted",
                        lambda c, out, device=None: ("undistort", out, device))
    got = tgen.main(["fundamental", *base, "--from-calibration", "--out", "f.pkl"], "cpu")
    assert got == ("fundamental", "f.pkl", True, "cpu")
    assert tgen.main(["pairwise", *base, "--out", "d"], "cpu") == ("pairwise", "d", "cpu")
    assert tgen.main(["undistort", *base], "cpu")[0] == "undistort"
    sel = tmp_path / "s.txt"
    sel.write_text("a/b_pseudo_label.h5\n")
    out = tgen.main(["pseudo-cfg", *base, "--select-file", str(sel), "--out",
                     str(tmp_path / "y")])
    assert [os.path.basename(p) for p in out] == ["pseudo_a_b.yaml"]
