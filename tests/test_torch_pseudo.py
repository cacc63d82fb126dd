"""The port's pseudo-label minting (pseudo/labeler.py) and H5 interchange
(data/h5io.py) against the JAX package on the CPU. The same numpy inputs go
to both packages."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from posetpu.data import h5io as jh5
from posetpu.data import synthetic as jsyn
from posetpu.geometry.cameras import project_points as jproject
from posetpu.pseudo import labeler as jlab
from posetpu_torch.data import h5io as th5
from posetpu_torch.data import synthetic as tsyn
from posetpu_torch.pseudo import labeler as tlab

G = 16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_scores_equal(seed):
    rs = np.random.RandomState(seed)
    gt = rs.uniform(0, 500, (G * 4, 16, 2)).astype(np.float32)
    pred = gt + rs.randn(*gt.shape).astype(np.float32) * 20
    vis = (rs.rand(G * 4, 16) > 0.3).astype(np.float32)
    hs = rs.uniform(20, 60, (G * 4, 1))
    for thr in (0.5, 0.2):
        args = (pred, gt, vis, hs, thr)
        assert tlab.pckh_weighted(*args) == jlab.pckh_weighted(*args)
    assert tlab.visibility_stats(vis) == jlab.visibility_stats(vis)
    acc, num = list(rs.uniform(0.8, 1.0, 9)), list(rs.uniform(0.1, 1.0, 9))
    acc[3] = acc[5]  # equal ranks
    assert tlab.pareto_select(acc, num) == jlab.pareto_select(acc, num)


def _mint_input():
    """Skeletons seen by the synthetic rig: 2 px noise, one view of 20 % of
    the group-joints 50-150 px off, confidences U(0.5, 1), head size 50."""
    rs = np.random.RandomState(7)
    jcams = jsyn.tile_cameras(jsyn.make_camera_ring(), G)
    poses = tsyn.make_skeleton_poses(G, seed=7)
    gt = np.asarray(jax.vmap(jax.vmap(jproject, in_axes=(None, 0)))(
        jnp.asarray(poses), jcams)).reshape(G * 4, 16, 2)
    pred = gt + rs.randn(*gt.shape).astype(np.float32) * 2.0
    g_, j_ = np.nonzero(rs.rand(G, 16) < 0.2)
    pred[g_ * 4 + rs.randint(0, 4, len(g_)), j_] += rs.uniform(50, 150, (len(g_), 2)).astype(
        np.float32)
    conf = rs.uniform(0.5, 1.0, (G * 4, 16)).astype(np.float32)
    flat = lambda cams: type(cams)(*[np.asarray(x).reshape((G * 4,) + x.shape[2:]) for x in cams])
    tcams = tsyn.tile_cameras(tsyn.make_camera_ring(), G)
    return pred, conf, gt, np.full((G * 4, 1), 50.0), flat(tcams), flat(jcams)


def _read_dir(out):
    files = sorted(os.listdir(out))
    lists = {}
    for name in ("select.txt", "delete.txt"):
        if name in files:
            with open(os.path.join(out, name)) as f:
                lists[name] = [os.path.relpath(p, out) for p in f.read().split()]
    h5 = {f: jh5.load_pseudo_labels(os.path.join(out, f)) for f in files if f.endswith(".h5")}
    return files, lists, h5


@pytest.mark.parametrize("mode", ["sweep", "loop"])
def test_mint_pseudo_labels_matches_jax(tmp_path, mode):
    """Equal file names, select.txt and delete.txt (relative to their
    directories), joints_vis and every entry's vis; pseudo_2d within 1e-3
    px, PCKh within 1e-6; the same choose()."""
    pred, conf, gt, hs, tcams, jcams = _mint_input()
    kw = dict(gt2d=gt, headsizes=hs, thresholds=(0.6, 0.7, 0.8), if_ransac=True,
              num_inliers=3, reproj_thre=10.0, use_reproj=True, loop=mode == "loop",
              confidence_thre=0.7, log=lambda *_: None)
    got = tlab.mint_pseudo_labels(pred, conf, tcams, str(tmp_path / "t"), device="cpu", **kw)
    want = jlab.mint_pseudo_labels(pred, conf, jcams, str(tmp_path / "j"), **kw)

    (t_files, t_lists, t_h5), (j_files, j_lists, j_h5) = (
        _read_dir(tmp_path / "t"), _read_dir(tmp_path / "j"))
    assert t_files == j_files and t_lists == j_lists
    assert len(t_h5) == (1 if mode == "loop" else 6)
    for name, (p2d, vis) in t_h5.items():
        assert np.abs(p2d - j_h5[name][0]).max() <= 1e-3, name
        assert np.array_equal(vis, j_h5[name][1]), name
    assert len(got["entries"]) == len(want["entries"])
    for a, b in zip(got["entries"], want["entries"]):
        assert a.keys() == b.keys() and a["tag"] == b["tag"] and a.get("name") == b.get("name")
        assert all(a[k] == b[k] for k in a if k.startswith("joints@") or k == "vis")
        assert abs(a["pckh"] - b["pckh"]) <= 1e-6
    assert got.get("selected") == want.get("selected")
    assert got["choose"]() == want["choose"]() and got["choose"](0.9) == want["choose"](0.9)
    ransac = [e for e in got["entries"] if e["tag"] == "after RANSAC"]
    assert all(0.2 < e["vis"] < 0.9 for e in ransac)


def test_mint_sweep_returns_the_written_arrays(tmp_path):
    """The device sweep alone gives the arrays the writer saves, and the
    entries (PCKh and vis) of the mint's summary."""
    pred, conf, gt, hs, tcams, _ = _mint_input()
    kw = dict(thresholds=(0.6, 0.8), num_inliers=3, use_reproj=True, gt2d=gt, headsizes=hs)
    stages = tlab.sweep_pseudo_labels(pred, conf, tcams, device="cpu", **kw)
    assert [s["tag"] for s in stages] == ["thre 0.6", "after RANSAC", "after reprojection",
                                          "thre 0.8", "after RANSAC", "after reprojection"]
    summary = tlab.mint_pseudo_labels(pred, conf, tcams, str(tmp_path), log=lambda *_: None,
                                      device="cpu", **kw)
    assert [s["entry"] for s in stages] == summary["entries"]
    assert all("pckh" in e for e in summary["entries"])
    assert [s["entry"]["name"] for s in stages if s["name"]] == ["0.6_0", "0.6_1",
                                                                "0.8_0", "0.8_1"]
    for s in stages:
        if s["save"]:
            p2d, vis = th5.load_pseudo_labels(str(tmp_path / f"{s['name']}_pseudo_label.h5"))
            assert np.array_equal(p2d, s["pred"].astype(np.float32))
            assert np.array_equal(vis, s["vis"])


def test_each_package_reads_the_other_h5(tmp_path):
    rs = np.random.RandomState(3)
    hm = rs.rand(8, 16, 8, 8).astype(np.float32)
    loc = rs.rand(8, 16, 3).astype(np.float32)
    order = np.arange(16)
    p2d, vis = rs.rand(8, 16, 2).astype(np.float32), (rs.rand(8, 16) > 0.5).astype(np.float32)
    for save, load in ((th5, jh5), (jh5, th5)):
        save.save_heatmaps(str(tmp_path / "hm.h5"), hm, loc, order)
        save.save_pseudo_labels(str(tmp_path / "pl.h5"), p2d, vis)
        for a, b in zip(load.load_heatmaps(str(tmp_path / "hm.h5")), (hm, loc, order)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        for a, b in zip(load.load_pseudo_labels(str(tmp_path / "pl.h5")), (p2d, vis)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
