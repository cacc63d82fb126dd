"""Pseudo-label minting: confidence thresholding + RANSAC + reprojection +
Pareto selection.

Equivalent of run/test/test_pseudo_label.py:89-287, with the per-point pymvg
loops replaced by the batched geometry (geometry/triangulate.py): the RANSAC
filter and the reprojection each run over all groups at once on the device,
one call per threshold. The scores and the selection stay host numpy, as the
reference computes them.

:func:`mint_pseudo_labels` is :func:`sweep_pseudo_labels` (the device work
and the scores, returning every stage's arrays and entry) followed by the
writer (the H5 files and the Pareto lists); the sweep runs where ``h5py`` is
absent.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from posetpu_torch import resolve_device
from posetpu_torch.data.h5io import save_pseudo_labels
from posetpu_torch.geometry.cameras import CameraParams
from posetpu_torch.geometry.triangulate import ransac_filter, reproject_poses


def pckh_weighted(pred2d, gt2d, joints_vis, headsizes, threshold: float = 0.5):
    """Visibility-weighted mean PCKh (my_eval, test_pseudo_label.py:89-105)."""
    pred2d = np.asarray(pred2d)
    gt2d = np.asarray(gt2d)
    joints_vis = np.asarray(joints_vis)
    dist = np.linalg.norm(gt2d - pred2d, axis=2)
    detected = (dist / np.asarray(headsizes)) <= threshold
    considered = detected * joints_vis
    denom = np.maximum(joints_vis.sum(0), 1e-12)
    rate = considered.sum(0) / denom
    ratio = joints_vis.sum(0) / max(joints_vis.sum(), 1e-12)
    return float(np.sum(ratio * rate))


def visibility_stats(joints_vis) -> dict:
    """Visible fraction and the per-group histogram of views a joint is
    visible in (test_pseudo_label.py:196-205)."""
    joints_vis = np.asarray(joints_vis)
    per_group = np.sum(joints_vis.reshape(-1, 4, joints_vis.shape[-1]), axis=1)
    stats = {"vis": float(joints_vis.sum() / joints_vis.size)}
    for k in range(5):
        stats[f"joints@{k}"] = float((per_group == k).sum() / per_group.size)
    return stats


def pareto_select(acc: Sequence[float], num: Sequence[float]) -> list[int]:
    """Pareto front over (accuracy, visible fraction), with the reference's
    rank-based dominance scan (test_pseudo_label.py:261-274)."""
    _, acc_order = np.unique(acc, return_inverse=True)
    _, num_order = np.unique(num, return_inverse=True)
    order = list(np.argsort(acc_order + num_order))
    selected: list[int] = []
    while order:
        ref = order.pop()
        selected.append(ref)
        order = [
            i for i in order
            if not (acc_order[i] <= acc_order[ref] and num_order[i] <= num_order[ref])
        ]
    return selected


def sweep_pseudo_labels(
    pred2d: np.ndarray,
    confidence: np.ndarray,
    cams: CameraParams,
    *,
    thresholds: Sequence[float] = (0.6, 0.7, 0.8, 0.9),
    if_ransac: bool = True,
    num_inliers: int = 4,
    reproj_thre: float = 10.0,
    use_reproj: bool = False,
    no_distortion: bool = False,
    loop: bool = False,
    confidence_thre: float = 0.6,
    gt2d: np.ndarray | None = None,
    headsizes: np.ndarray | None = None,
    device=None,
) -> list[dict]:
    """The device half of :func:`mint_pseudo_labels`: its stages in order,
    each ``{"tag", "name" (None for an unnamed stage), "pred" [N, J, 2],
    "vis" [N, J], "save", "entry"}`` with host arrays. ``entry`` is the
    stage's summary entry: its visibility stats, its ``name`` where it has
    one, and its ``pckh`` where ``gt2d`` and ``headsizes`` are given. The
    threshold and the scores run on the host, RANSAC and the reprojection on
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    n, j, _ = pred2d.shape
    g = n // 4
    pred_g = torch.as_tensor(np.asarray(pred2d, np.float32)).reshape(g, 4, j, 2).to(dev)
    cams_g = cams.map(lambda x: torch.as_tensor(x).reshape((g, 4) + tuple(x.shape[1:])).to(dev))
    on_dev = lambda vis: torch.from_numpy(vis.reshape(g, 4, j)).to(dev)

    stages = []
    for conf_thre in [confidence_thre] if loop else list(thresholds):
        joints_vis = (confidence > conf_thre).astype(np.float32)
        stages.append({"tag": f"thre {conf_thre}", "name": f"{conf_thre}_0", "pred": pred2d,
                       "vis": joints_vis, "save": not (loop and if_ransac)})
        if if_ransac:
            joints_vis = ransac_filter(pred_g, cams_g, on_dev(joints_vis), reproj_thre,
                                       num_inliers, no_distortion).cpu().numpy().reshape(n, j)
            stages.append({"tag": "after RANSAC", "name": None, "pred": pred2d,
                           "vis": joints_vis, "save": False})
        if use_reproj:
            proj_g, res_vis_g = reproject_poses(pred_g, cams_g, on_dev(joints_vis),
                                                no_distortion)
            stages.append({"tag": "after reprojection", "name": f"{conf_thre}_1",
                           "pred": proj_g.cpu().numpy().reshape(n, j, 2),
                           "vis": res_vis_g.cpu().numpy().reshape(n, j), "save": True})
    for stage in stages:
        entry = stage["entry"] = {"tag": stage["tag"], **visibility_stats(stage["vis"])}
        if gt2d is not None and headsizes is not None:
            entry["pckh"] = pckh_weighted(stage["pred"], gt2d, stage["vis"], headsizes)
        if stage["name"] is not None:
            entry["name"] = stage["name"]
    return stages


def mint_pseudo_labels(
    pred2d: np.ndarray,
    confidence: np.ndarray,
    cams: CameraParams,
    out_dir: str,
    *,
    gt2d: np.ndarray | None = None,
    headsizes: np.ndarray | None = None,
    thresholds: Sequence[float] = (0.6, 0.7, 0.8, 0.9),
    if_ransac: bool = True,
    num_inliers: int = 4,
    reproj_thre: float = 10.0,
    use_reproj: bool = False,
    no_distortion: bool = False,
    loop: bool = False,
    confidence_thre: float = 0.6,
    log=print,
    device=None,
) -> dict:
    """The full sweep of test_pseudo_label.py:191-287.

    pred2d [N, J, 2] decoded 2D (N = groups * 4, grouping-flattened order);
    confidence [N, J] heatmap maxima; cams: CameraParams with leading [N].
    Writes ``<thre>_0_pseudo_label.h5`` (confidence only) and, with
    ``use_reproj``, ``<thre>_1_pseudo_label.h5`` (reprojected), then the
    Pareto ``select.txt`` / ``delete.txt``. Returns a summary dict with its
    ``entries``, ``selected`` and ``choose``. RANSAC and the reprojection
    run on ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    stages = sweep_pseudo_labels(
        pred2d, confidence, cams, thresholds=thresholds, if_ransac=if_ransac,
        num_inliers=num_inliers, reproj_thre=reproj_thre, use_reproj=use_reproj,
        no_distortion=no_distortion, loop=loop, confidence_thre=confidence_thre,
        gt2d=gt2d, headsizes=headsizes, device=dev)

    names: list[str] = []
    acc: list[float] = []
    num: list[float] = []
    summary: dict = {"entries": []}
    for stage in stages:
        entry, name = stage["entry"], stage["name"]
        if "pckh" in entry:
            log(f"{entry['tag']}: PCKh@0.5={entry['pckh']:.3f} vis={entry['vis']:.2f}")
        else:
            log(f"{entry['tag']}: vis={entry['vis']:.2f}")
        summary["entries"].append(entry)
        if name is not None:
            acc.append(entry.get("pckh", 0.0))
            num.append(entry["vis"])
            names.append(name)
        if stage["save"]:
            path = os.path.join(out_dir, f"{name}_pseudo_label.h5")
            save_pseudo_labels(path, stage["pred"], stage["vis"])
            log(f"=> saved {path}")

    def choose(min_vis: float = 0.10):
        """Automatic pick from the Pareto front: the reference publishes
        select.txt for a human to choose from (test_pseudo_label.py:
        261-286); this maximises PCKh * vis (the expected fraction of joints
        that get a correct label) over the selected entries that clear
        ``min_vis``, falling back to the most visible entry. Max-PCKh alone
        can pick near-perfect labels on almost no joints and starve the next
        iteration of supervision."""
        sel = summary.get("selected") or names
        cand = [e for e in summary["entries"] if e.get("name") in sel]
        ok = [e for e in cand if e["vis"] >= min_vis]
        pool = ok or cand
        key = ((lambda e: e.get("pckh", 0.0) * e["vis"]) if ok
               else (lambda e: e["vis"]))
        return max(pool, key=key)["name"]

    summary["choose"] = choose

    if not loop:
        selected = pareto_select(acc, num)
        with open(os.path.join(out_dir, "select.txt"), "w") as f:
            for idx in selected:
                f.write(os.path.join(out_dir, f"{names[idx]}_pseudo_label.h5") + "\n")
        removed = [k for k in range(len(names)) if k not in selected]
        with open(os.path.join(out_dir, "delete.txt"), "w") as f:
            for idx in removed:
                f.write(os.path.join(out_dir, f"{names[idx]}_pseudo_label.h5") + "\n")
        summary["selected"] = [names[i] for i in selected]
    return summary
