"""Pseudo-label minting entry point: run/test/test_pseudo_label.py.

    python -m posetpu_torch.cli.pseudo_labels --cfg <yaml> --heatmap <h5> \
        [--ransac --inliers 3 --reproj-thre 10 --use-reproj --loop \
         --confidence-thre 0.7 --no-distortion]

RANSAC and the reprojection run on the GPU.
"""

from __future__ import annotations

import copy
import os

import numpy as np


def parse_args():
    from posetpu_torch.cli.common import base_parser

    p = base_parser("Mint pseudo labels from a heatmap dump")
    p.add_argument("--heatmap", required=True, help="heatmaps_locations H5")
    p.add_argument("--confidence-thre", type=float, default=0.0)
    p.add_argument("--ransac", action="store_true")
    p.add_argument("--inliers", type=int, default=0)
    p.add_argument("--reproj-thre", type=float, default=0.0)
    p.add_argument("--use-reproj", action="store_true")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--no-distortion", action="store_true")
    return p.parse_args()


def run(cfg, heatmap: str, cfg_path: str, *, confidence_thre: float = 0.0,
        ransac: bool = False, inliers: int = 0, reproj_thre: float = 0.0,
        use_reproj: bool = False, loop: bool = False, no_distortion: bool = False,
        log=print, device=None) -> dict:
    """Mint pseudo labels from ``heatmap`` over the training subset. The
    keyword arguments are the command's flags (a 0 / False keeps the
    config's PSEUDO_LABEL value); ``cfg_path`` (the ``--cfg`` file) names
    the output directory. ``cfg`` is not modified."""
    from posetpu_torch import resolve_device
    from posetpu_torch.data.base import sorted_union_indices
    from posetpu_torch.data.h5io import load_heatmaps
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.pseudo import mint_pseudo_labels

    dev = resolve_device(device)
    cfg = copy.deepcopy(cfg)
    pl = cfg.PSEUDO_LABEL
    if confidence_thre:
        pl.CONFIDENCE_THRE = confidence_thre
    if ransac:
        pl.IF_RANSAC = True
    if inliers:
        pl.NUM_INLIERS = inliers
    if reproj_thre:
        pl.REPROJ_THRE = reproj_thre
    if use_reproj:
        pl.USE_REPROJ = True
    if loop:
        pl.IF_LOOP = True
    no_distortion = no_distortion or cfg.DATASET.NO_DISTORTION

    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, "train", True, no_distortion=no_distortion
    )
    _, locations, _ = load_heatmaps(heatmap)
    pred2d = locations[:, :, :2]
    confidence = locations[:, :, 2]
    if len(pred2d) != len(dataset.grouping) * 4:
        raise ValueError(f"{heatmap}: {len(pred2d)} rows, the training grouping has "
                         f"{len(dataset.grouping) * 4}")

    u = sorted_union_indices(dataset.u2a_mapping)
    gt2d_all, _ = dataset.gt_joints_flat()
    gt2d = gt2d_all[:, u]
    flat = [i for g in dataset.grouping for i in g]
    scales = np.array([dataset.db[i]["scale"] for i in flat])
    headsizes = np.amax(scales, axis=1, keepdims=True) * 200 / 10.0

    out_dir = os.path.join(
        cfg.OUTPUT_DIR, "test",
        os.path.splitext(os.path.basename(cfg_path))[0]
        + (f"_{cfg.POSE_RESNET.NUM_LAYERS}" if cfg.POSE_RESNET.NUM_LAYERS != 50 else ""),
        f"{pl.NUM_INLIERS}_{pl.REPROJ_THRE}",
    )
    return mint_pseudo_labels(
        pred2d,
        confidence,
        dataset.cameras_flat(),
        out_dir,
        gt2d=gt2d,
        headsizes=headsizes,
        if_ransac=bool(pl.IF_RANSAC),
        num_inliers=int(pl.NUM_INLIERS),
        reproj_thre=float(pl.REPROJ_THRE),
        use_reproj=bool(pl.USE_REPROJ),
        no_distortion=no_distortion,
        loop=bool(pl.IF_LOOP),
        confidence_thre=float(pl.CONFIDENCE_THRE),
        log=log,
        device=dev,
    )


def main():
    args = parse_args()
    from posetpu_torch.cli.common import load_cfg

    cfg = load_cfg(args)
    return run(cfg, args.heatmap, args.cfg, confidence_thre=args.confidence_thre,
               ransac=args.ransac, inliers=args.inliers, reproj_thre=args.reproj_thre,
               use_reproj=args.use_reproj, loop=args.loop,
               no_distortion=args.no_distortion)


if __name__ == "__main__":
    main()
