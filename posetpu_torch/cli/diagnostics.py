"""Diagnostic harnesses: run/test's analysis scripts.

Subcommands:
    ransac-report   error-CDF table of the RANSAC-filtered triangulation
                    (test_ransac.py:60-121)
    fund-residual   epipolar residuals of the predictions against the F bank
                    (test_fund_mtx.py:58-71)
    integral-check  the integral (soft-argmax) decode against the argmax one
                    through the same evaluator (test_integral.py:63-99)

    python -m posetpu_torch.cli.diagnostics <subcommand> --cfg <yaml> [--heatmap h5]

Each subcommand reads the heatmap H5 dump (it needs h5py) and hands the
arrays to its body (``*_arrays``), which runs on CUDA unless the caller
passes ``device="cpu"``; integral-check's argmax decode is the B7 kernel
there.
"""

from __future__ import annotations

import numpy as np
import torch


def _dataset(cfg):
    from posetpu_torch.data.registry import get_dataset

    return get_dataset(cfg.DATASET.TEST_DATASET)(cfg, cfg.DATASET.TEST_SUBSET, False)


def ransac_report(cfg, heatmap: str, log=print, device=None):
    from posetpu_torch.data.h5io import load_heatmaps

    return ransac_report_arrays(cfg, _dataset(cfg), load_heatmaps(heatmap)[1], log, device)


def ransac_report_arrays(cfg, dataset, locations, log=print, device=None) -> dict:
    """The share of the RANSAC-kept joints within 10-150 mm of the GT, their
    mean error and the kept share. locations [N, J, 3] (x, y, confidence)
    in grouping order, N = 4 G."""
    from posetpu_torch import resolve_device
    from posetpu_torch.cli.triangulate import gt_world_joints
    from posetpu_torch.geometry.triangulate import ransac_filter, triangulate_points

    dev = resolve_device(device)
    locations = np.asarray(locations)
    pred2d, conf = locations[:, :, :2], locations[:, :, 2]
    n, j, _ = pred2d.shape
    g = n // 4
    cams_g = dataset.cameras_flat().map(lambda x: x.reshape((g, 4) + x.shape[1:]).to(dev))
    p2d = torch.as_tensor(pred2d.reshape(g, 4, j, 2), dtype=torch.float32, device=dev)
    vis = torch.as_tensor((conf > cfg.PSEUDO_LABEL.CONFIDENCE_THRE).reshape(g, 4, j),
                          dtype=torch.float32, device=dev)
    no_dist = bool(cfg.DATASET.NO_DISTORTION)
    res_vis = ransac_filter(p2d, cams_g, vis, float(cfg.PSEUDO_LABEL.REPROJ_THRE),
                            int(cfg.PSEUDO_LABEL.NUM_INLIERS), no_dist)
    pred3d = triangulate_points(p2d, cams_g, res_vis, no_dist).cpu().numpy()
    res_vis = res_vis.cpu().numpy()

    pairs = sorted((k, v) for k, v in dataset.u2a_mapping.items() if v != "*")
    gt3d = gt_world_joints(dataset, dataset.grouping)[:, np.array([v for _, v in pairs])]

    valid = res_vis.sum(axis=1) >= 2  # [G, J]
    err_valid = np.linalg.norm(pred3d - gt3d, axis=-1)[valid]
    table = {f"<={thr}mm": float((err_valid <= thr).mean()) if err_valid.size else 0.0
             for thr in (10, 20, 30, 50, 100, 150)}
    table["mean_mm"] = float(err_valid.mean()) if err_valid.size else -1.0
    table["kept_frac"] = float(valid.mean())
    log(" | ".join(f"{k}: {v:.3f}" for k, v in table.items()))
    return table


def fund_residual(cfg, heatmap: str, log=print):
    from posetpu_torch.data.base import sorted_union_indices
    from posetpu_torch.data.h5io import load_heatmaps

    dataset = _dataset(cfg)
    if heatmap:
        pts = load_heatmaps(heatmap)[1][:, :, :2]
    else:
        pts = dataset.gt_joints_flat()[0][:, sorted_union_indices(dataset.u2a_mapping)]
    return fund_residual_arrays(dataset, pts, log)


def fund_residual_arrays(dataset, pts, log=print) -> dict:
    """Mean and max of |x_b^T F x_a| over every group and ordered view pair,
    F from the calibration (host numpy, as the reference). pts [N, J, 2]."""
    from posetpu_torch.core.losses import VIEW_PERMS
    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.fundamental import build_fundamental_bank

    pts = np.asarray(pts)
    n, j, _ = pts.shape
    g = n // 4
    pts_g = pts.reshape(g, 4, j, 2)
    cams_by_subject, subj_of_group = {}, []
    for items in dataset.grouping:
        subj = dataset.db[items[0]]["subject"]
        subj_of_group.append(subj)
        if subj not in cams_by_subject:
            cams_by_subject[subj] = CameraParams.stack(
                [CameraParams.from_dict(dataset.db[i]["camera"]) for i in items])
    bank = build_fundamental_bank(cams_by_subject)

    homo = np.concatenate([pts_g, np.ones((g, 4, j, 1))], axis=-1)
    res = np.concatenate([
        np.abs(np.einsum("jk,kl,jl->j", homo[gi, vb], bank[(subj_of_group[gi], va, vb)],
                         homo[gi, va]))
        for gi in range(g) for va, vb in VIEW_PERMS])
    stats = {"mean": float(res.mean()), "max": float(res.max())}
    log(f"epipolar residual: mean {stats['mean']:.4f} max {stats['max']:.4f}")
    return stats


def integral_check(cfg, heatmap: str, log=print, device=None):
    from posetpu_torch.data.h5io import load_heatmaps

    return integral_check_arrays(_dataset(cfg), load_heatmaps(heatmap)[0], log, device)


def integral_check_arrays(dataset, heatmaps, log=print, device=None) -> dict:
    """PCKh of the argmax decode (ops/decode: the B7 kernel on CUDA) and of
    the soft-argmax decode of the same maps, both mapped back to the image
    by each record's center and scale. heatmaps [N, J, h, w] (an array or
    a tensor) in grouping order."""
    from posetpu_torch import resolve_device
    from posetpu_torch.ops.affine import transform_preds
    from posetpu_torch.ops.decode import decode_heatmaps_kernel
    from posetpu_torch.ops.heatmap import soft_argmax_2d

    dev = resolve_device(device)
    hm = torch.as_tensor(heatmaps, dtype=torch.float32, device=dev)
    flat = [i for items in dataset.grouping for i in items]
    centers = torch.as_tensor(np.array([dataset.db[i]["center"] for i in flat], np.float32),
                              device=dev)
    scales = torch.as_tensor(np.array([dataset.db[i]["scale"] for i in flat], np.float32),
                             device=dev)
    h, w = hm.shape[2], hm.shape[3]
    results = {}
    for name, coords in (("argmax", decode_heatmaps_kernel(hm)[0]),
                         ("integral", soft_argmax_2d(hm))):
        preds = transform_preds(coords, centers, scales, (w, h)).cpu().numpy()
        _, mean = dataset.evaluate(preds)
        results[name] = float(mean)
        log(f"{name}: PCKh {mean:.4f}")
    return results


def main(argv=None, device=None):
    import argparse

    from posetpu_torch.cli.common import load_cfg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", choices=["ransac-report", "fund-residual", "integral-check"])
    p.add_argument("--cfg", required=True)
    p.add_argument("--heatmap", default="")
    p.add_argument("--modelDir", default="")
    p.add_argument("--logDir", default="")
    p.add_argument("--dataDir", default="")
    args = p.parse_args(argv)
    cfg = load_cfg(args)
    if args.command == "fund-residual":
        return fund_residual(cfg, args.heatmap)
    fn = {"ransac-report": ransac_report, "integral-check": integral_check}[args.command]
    return fn(cfg, args.heatmap, device=device)


if __name__ == "__main__":
    main()
