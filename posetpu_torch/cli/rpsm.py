"""RPSM 3D evaluation: run/test/test_rpsm.py's equivalent.

    python -m posetpu_torch.cli.rpsm --cfg <yaml> --heatmap <h5> \
        [--limb-file <pkl>] [--max-groups N]

Reads the heatmap H5 dump, runs batched RPSM over the 4-view groups and
reports MPJPE against the world-frame GT. Limb lengths come from the mean
GT 3D pose (the in-framework analogue of the reference's pairwise / limb
pickles) or from a reference limb-length pickle. Runs on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch


def parse_args():
    from posetpu_torch.cli.common import base_parser

    p = base_parser("RPSM 3D refinement benchmark")
    p.add_argument("--heatmap", required=True)
    p.add_argument("--limb-file", default="", help="reference limb-length pickle")
    p.add_argument("--max-groups", type=int, default=0)
    return p.parse_args()


def run(cfg, heatmap: str, limb_file: str = "", max_groups: int = 0, log=print,
        device=None):
    from posetpu_torch import resolve_device
    from posetpu_torch.cli.triangulate import gt_world_joints
    from posetpu_torch.data.h5io import load_heatmaps
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.body import ROOT_IDX, edges
    from posetpu_torch.geometry.cameras import CameraParams
    from posetpu_torch.geometry.pictorial import limb_lengths_from_pose, rpsm

    dev = resolve_device(device)
    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, cfg.DATASET.TEST_SUBSET, False
    )
    heatmaps, _, u = load_heatmaps(heatmap)
    n, j, hh, hw = heatmaps.shape
    g = n // 4
    if max_groups:
        g = min(g, max_groups)

    # world-frame GT in the union joint order (u2a)
    pairs = sorted((k, v) for k, v in dataset.u2a_mapping.items() if v != "*")
    a = np.array([v for _, v in pairs])
    groups = dataset.grouping[:g]
    gt3d = gt_world_joints(dataset, groups)[:, a]  # [G, J, 3] union order
    centers = [[dataset.db[i]["center"] for i in items] for items in groups]
    scales = [[dataset.db[i]["scale"] for i in items] for items in groups]
    cams = CameraParams.stack([
        CameraParams.stack([CameraParams.from_dict(dataset.db[i]["camera"]) for i in items])
        for items in groups
    ]).map(lambda x: x.to(dev))
    if limb_file:
        import pickle

        with open(limb_file, "rb") as f:
            limb_dict = pickle.load(f)
        limbs = torch.tensor([float(limb_dict[e]) for e in edges()], dtype=torch.float32)
    else:
        limbs = limb_lengths_from_pose(torch.from_numpy(gt3d.mean(axis=0)))

    out = rpsm(
        torch.from_numpy(heatmaps[: g * 4].reshape(g, 4, j, hh, hw)).to(dev),
        cams,
        torch.from_numpy(np.array(centers, np.float32)).to(dev),
        torch.from_numpy(np.array(scales, np.float32)).to(dev),
        torch.from_numpy(gt3d[:, ROOT_IDX].copy()).to(dev),
        limbs.to(dev),
        cfg,
    )
    err = np.linalg.norm(out.cpu().numpy() - gt3d, axis=-1)
    stats = {"mpjpe_mm": float(err.mean()), "max_mm": float(err.max())}
    log(f"RPSM MPJPE: {stats['mpjpe_mm']:.2f} mm (max {stats['max_mm']:.1f})")
    return stats


def main():
    args = parse_args()
    from posetpu_torch.cli.common import load_cfg

    cfg = load_cfg(args)
    return run(cfg, args.heatmap, args.limb_file, args.max_groups)


if __name__ == "__main__":
    main()
