"""Offline artifact generators: run/test's generate_* scripts.

Subcommands:
    fundamental   per-(subject, view-pair) F matrices
                  (generate_fundamental_matirx.py:33-103): from GT joints by
                  the normalised 8-point estimator, or exactly from the
                  calibration with --from-calibration; checks the residuals
                  on held-out frames as the reference does
    pairwise      limb lengths and the first iteration's 16^3 pairwise
                  constraint tables (generate_pairwise_constraints.py:31-111)
    undistort     an H36M set without lens distortion (undistort_image.py +
                  test_proj2d.py), each image remapped on the device
    pseudo-cfg    experiment YAMLs from a select.txt
                  (generate_pseudo_cfg.py:43-101)

    python -m posetpu_torch.cli.generate <subcommand> --cfg <yaml> ...

The device work (the 8-point fits, the constraint tables, the remap) runs
on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32), device=dev)


def generate_fundamental(cfg, out_path: str, from_calibration: bool = False,
                         holdout: int = 50, log=print, device=None):
    """The F bank {(subject, a, b): [3, 3] float32} written as a pickle at
    ``out_path``: fitted to the GT joints of each subject's groups but the
    last ``holdout`` (the 8-point estimator in f32 on ``device``), or exact
    from the calibration; the held-out groups' epipolar residuals logged."""
    from posetpu_torch import resolve_device
    from posetpu_torch.core.losses import VIEW_PERMS
    from posetpu_torch.data.base import sorted_union_indices
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.fundamental import build_fundamental_bank, eight_point

    dev = resolve_device(device)
    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, "train", True)
    u = sorted_union_indices(dataset.u2a_mapping)
    pts, _ = dataset.gt_joints_flat()
    pts = pts[:, u]
    g = pts.shape[0] // 4
    pts_g = pts.reshape(g, 4, -1, 2)
    subj_of_group = [dataset.db[items[0]]["subject"] for items in dataset.grouping]

    bank = {}
    if from_calibration:
        cams_by_subject = {}
        for items, subj in zip(dataset.grouping, subj_of_group):
            if subj not in cams_by_subject:
                cams_by_subject[subj] = CameraParams.stack(
                    [CameraParams.from_dict(dataset.db[i]["camera"]) for i in items])
        bank = build_fundamental_bank(cams_by_subject)
    else:
        for s in sorted(set(subj_of_group)):
            groups = [i for i, ss in enumerate(subj_of_group) if ss == s]
            fit = groups[:-holdout] or groups
            for a, b in VIEW_PERMS:
                p1 = _f32(pts_g[fit, a].reshape(-1, 2), dev)
                p2 = _f32(pts_g[fit, b].reshape(-1, 2), dev)
                bank[(s, a, b)] = eight_point(p1, p2).cpu().numpy().astype(np.float32)

    # the check on held-out frames (generate_fundamental_matirx.py:50-63)
    res_all = []
    ones = np.ones((pts_g.shape[2], 1))
    for gi in range(max(g - holdout, 0), g):
        s = subj_of_group[gi]
        for a, b in VIEW_PERMS:
            h1 = np.concatenate([pts_g[gi, a], ones], 1)
            h2 = np.concatenate([pts_g[gi, b], ones], 1)
            res_all.append(np.abs(np.einsum("jk,kl,jl->j", h2, bank[(s, a, b)], h1)))
    res_all = np.concatenate(res_all) if res_all else np.zeros(1)
    log(f"heldout residual: mean {res_all.mean():.4f} max {res_all.max():.4f}")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(bank, f)
    log(f"=> {out_path} ({len(bank)} matrices)")
    return bank


def generate_pairwise(cfg, out_dir: str, log=print, device=None):
    """``limb_length.pkl`` (the mean limb lengths of the first 500 groups'
    world-frame GT poses) and ``pairwise_b<FIRST_NBINS>.pkl`` (per edge the
    [n^3, n^3] limb-length indicator on the first iteration's grid, computed
    on ``device``) written into ``out_dir``; returns both dicts."""
    from posetpu_torch import resolve_device
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.body import edges
    from posetpu_torch.geometry.cameras import camera_to_world_frame
    from posetpu_torch.geometry.pictorial import (
        compute_grid,
        limb_lengths_from_pose,
        pairwise_constraints,
    )

    dev = resolve_device(device)
    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, "train", True)
    pairs = sorted((k, v) for k, v in dataset.u2a_mapping.items() if v != "*")
    a = np.array([v for _, v in pairs])

    poses = []
    for items in dataset.grouping[:500]:
        rec = dataset.db[items[-1]]
        cam = rec["camera"]
        world = camera_to_world_frame(_f32(rec["joints_3d"], dev), _f32(cam["R"], dev),
                                      _f32(np.reshape(cam["T"], 3), dev))
        poses.append(world.cpu().numpy()[a])
    mean_pose = np.mean(poses, axis=0)
    limbs = limb_lengths_from_pose(torch.from_numpy(mean_pose)).numpy()
    limb_dict = {e: float(v) for e, v in zip(edges(), limbs)}

    nbins = int(cfg.PICT_STRUCT.FIRST_NBINS)
    grid = compute_grid(float(cfg.PICT_STRUCT.GRID_SIZE),
                        torch.zeros(3, dtype=torch.float32, device=dev), nbins)
    tol = float(cfg.PICT_STRUCT.LIMB_LENGTH_TOLERANCE)
    constraints = {e: pairwise_constraints(grid, grid, limb_dict[e], tol).cpu().numpy()
                   for e in edges()}

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "limb_length.pkl"), "wb") as f:
        pickle.dump(limb_dict, f)
    with open(os.path.join(out_dir, f"pairwise_b{nbins}.pkl"), "wb") as f:
        pickle.dump(constraints, f)
    log(f"=> {out_dir}: limb_length.pkl, pairwise_b{nbins}.pkl")
    return limb_dict, constraints


def undistort_image(img, cam, device=None) -> np.ndarray:
    """One image [h, w, 3] (uint8) remapped so that a pinhole camera
    reproduces it: dst(u) = src(distort(u)), each pixel sampled bilinearly
    at its distorted location (ops/warp.bilinear_sample) on ``device``;
    rounded down to uint8 after clipping to [0, 255], as the JAX package
    does. ``cam``: a geometry/cameras.CameraParams of one view."""
    from posetpu_torch import resolve_device
    from posetpu_torch.geometry.cameras import distort_opencv
    from posetpu_torch.ops.warp import bilinear_sample

    dev = resolve_device(device)
    f, c, k, p = (x.to(dev) for x in (cam.f, cam.c, cam.k, cam.p))
    h, w = img.shape[:2]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    norm = torch.stack([(gx - c[0]) / f[0], (gy - c[1]) / f[1]], -1)
    src = distort_opencv(norm.reshape(-1, 2), k, p) * f + c
    out = bilinear_sample(torch.as_tensor(img, device=dev).float(), src[:, 0].reshape(h, w),
                          src[:, 1].reshape(h, w))
    return out.clamp(0, 255).to(torch.uint8).cpu().numpy()


def generate_undistorted(cfg, out_root: str, max_groups: int = 0, log=print, device=None):
    """An undistortion-free H36M set under ``out_root``
    (run/test/undistort_image.py + test_proj2d.py): every image of the test
    subset remapped (:func:`undistort_image`), the annotations projected
    again by the pinhole alone, the camera's distortion zeroed, and the
    records written as ``h36m_<subset>_nodistortion.pkl``, the name the data
    set reads with NO_DISTORTION. Returns the pickle's path."""
    import copy

    import cv2

    from posetpu_torch.data import zipreader
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.cameras import CameraParams

    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(cfg, cfg.DATASET.TEST_SUBSET, False)
    os.makedirs(os.path.join(out_root, "h36m", "images"), exist_ok=True)
    new_db = []
    groups = dataset.grouping[:max_groups] if max_groups else dataset.grouping
    for items in groups:
        for idx in items:
            rec = copy.deepcopy(dataset.db[idx])
            cam = CameraParams.from_dict(rec["camera"])
            und = undistort_image(zipreader.imread(dataset._image_path(rec)), cam, device)
            out_img = os.path.join(out_root, "h36m", "images", rec["image"])
            os.makedirs(os.path.dirname(out_img), exist_ok=True)
            cv2.imwrite(out_img, und)

            # the pinhole projection of the camera-frame 3D, in the
            # annotation's own joint order (the loader maps it on load)
            xc = np.asarray(rec["joints_3d"], np.float64)
            f, c = cam.f.numpy(), cam.c.numpy()
            pin = xc[:, :2] / xc[:, 2:3] * f + c
            rec["joints_2d"] = pin.astype(np.float64)
            rec["joints_vis"] = np.ones((len(pin), 3))
            rec["camera"] = dict(rec["camera"])
            rec["camera"]["k"] = np.zeros((3, 1))
            rec["camera"]["p"] = np.zeros((2, 1))
            new_db.append(rec)

    annot_dir = os.path.join(out_root, "h36m", "annot")
    os.makedirs(annot_dir, exist_ok=True)
    out_pkl = os.path.join(annot_dir, f"h36m_{cfg.DATASET.TEST_SUBSET}_nodistortion.pkl")
    with open(out_pkl, "wb") as fh:
        pickle.dump(new_db, fh)
    log(f"=> {out_pkl} ({len(new_db)} records)")
    return out_pkl


def generate_pseudo_cfg(base_cfg_path: str, select_file: str, out_dir: str, log=print):
    """One experiment YAML per pseudo-label file listed in ``select_file``
    (generate_pseudo_cfg.py:43-101): the base YAML with
    ``DATASET.PSEUDO_LABEL_PATH`` set. Returns the paths written."""
    import yaml

    with open(base_cfg_path) as f:
        base = yaml.safe_load(f) or {}
    with open(select_file) as f:
        selected = [line.strip() for line in f if line.strip()]

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for path in selected:
        tag = os.path.basename(path).replace("_pseudo_label.h5", "")
        # the sweep's {inliers}_{reproj} is the parent directory's name: it
        # joins the tag as the reference's prefix + dir_name + '_' + name
        # (generate_pseudo_cfg.py:70-72), so that files of one name from
        # two sweep directories do not overwrite each other
        parent = os.path.basename(os.path.dirname(path))
        if parent and parent not in ("", "."):
            tag = f"{parent}_{tag}"
        cfg = dict(base)
        cfg["DATASET"] = dict(cfg.get("DATASET", {}))
        cfg["DATASET"]["PSEUDO_LABEL_PATH"] = path
        out = os.path.join(out_dir, f"pseudo_{tag}.yaml")
        with open(out, "w") as f:
            yaml.dump(cfg, f, default_flow_style=False)
        written.append(out)
        log(f"=> {out}")
    return written


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("command", choices=["fundamental", "pairwise", "pseudo-cfg", "undistort"])
    p.add_argument("--cfg", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--from-calibration", action="store_true")
    p.add_argument("--select-file", default="")
    p.add_argument("--modelDir", default="")
    p.add_argument("--logDir", default="")
    p.add_argument("--dataDir", default="")
    return p.parse_args(argv)


def main(argv=None, device=None):
    from posetpu_torch.cli.common import load_cfg

    args = parse_args(argv)
    cfg = load_cfg(args)
    if args.command == "fundamental":
        out = args.out or os.path.join(cfg.DATASET.ROOT, "testdata", "fundamental_matrix.pkl")
        return generate_fundamental(cfg, out, args.from_calibration, device=device)
    if args.command == "pairwise":
        return generate_pairwise(cfg, args.out or os.path.join(cfg.DATASET.ROOT, "testdata"),
                                 device=device)
    if args.command == "undistort":
        return generate_undistorted(cfg, args.out or cfg.DATASET.ROOT, device=device)
    return generate_pseudo_cfg(args.cfg, args.select_file, args.out or "experiments/pseudo")


if __name__ == "__main__":
    main()
