"""3D triangulation benchmark: run/test/test_triangulate.py's equivalent.

    python -m posetpu_torch.cli.triangulate --cfg <yaml> [--heatmap <h5>] \
        [--no-distortion]

Without ``--heatmap`` it triangulates the GT 2D joints (the built-in oracle:
MPJPE ~0); with one it reads the validation H5 dump and reports H36M
triangulation MPJPE. Runs on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch


def parse_args():
    from posetpu_torch.cli.common import base_parser

    p = base_parser("DLT triangulation MPJPE benchmark")
    p.add_argument("--heatmap", default="", help="heatmaps_locations H5 (omit for GT)")
    p.add_argument("--no-distortion", action="store_true")
    return p.parse_args()


def gt_world_joints(dataset, groups) -> np.ndarray:
    """World-frame GT 3D [G, 17, 3] of each group, from its last view's
    camera-frame annotation (test_triangulate.py:69-80)."""
    from posetpu_torch.geometry.cameras import camera_to_world_frame

    recs = [dataset.db[items[-1]] for items in groups]
    f32 = lambda arrays: torch.from_numpy(
        np.array([np.asarray(x, np.float64) for x in arrays]).astype(np.float32))
    return camera_to_world_frame(f32(r["joints_3d"] for r in recs),
                                 f32(r["camera"]["R"] for r in recs),
                                 f32(np.reshape(r["camera"]["T"], 3) for r in recs)).numpy()


def run(cfg, heatmap: str = "", no_distortion: bool = False, log=print, device=None):
    from posetpu_torch import resolve_device
    from posetpu_torch.data.h5io import load_heatmaps
    from posetpu_torch.data.registry import get_dataset
    from posetpu_torch.geometry.triangulate import triangulate_poses

    dev = resolve_device(device)
    dataset = get_dataset(cfg.DATASET.TEST_DATASET)(
        cfg, cfg.DATASET.TEST_SUBSET, False, no_distortion=no_distortion
    )
    cams = dataset.cameras_flat().map(lambda x: x.to(dev))

    if heatmap:
        _, locations, _ = load_heatmaps(heatmap)
        pred2d = locations[:, :, :2]
        test_gt = False
    else:
        pred2d, _ = dataset.gt_joints_flat()
        test_gt = True

    gt3d = gt_world_joints(dataset, dataset.grouping)
    pred3d = triangulate_poses(torch.as_tensor(np.asarray(pred2d, np.float32)).to(dev), cams,
                               no_distortion=no_distortion).cpu().numpy()

    pairs = sorted((k, v) for k, v in dataset.u2a_mapping.items() if v != "*")
    u = np.array([k for k, _ in pairs])
    a = np.array([v for _, v in pairs])
    compatible_pred = pred3d[:, u] if test_gt else pred3d
    compatible_gt = gt3d[:, a]

    norm = np.linalg.norm(compatible_pred - compatible_gt, axis=2)
    stats = {
        "mean_mm": float(norm.mean()),
        "std_mm": float(norm.std()),
        "max_mm": float(norm.max()),
        "tail_frac": float((norm > norm.mean() + norm.std()).sum() / norm.size),
    }
    log(f"Mean Error: {stats['mean_mm']:.2f}")
    log(f"Std Error: {stats['std_mm']:.2f}")
    log(f"Max Error: {stats['max_mm']:.2f}")
    log(f"Larger than Mean+Std Error: {stats['tail_frac']:.1%}")
    return stats


def main():
    args = parse_args()
    from posetpu_torch.cli.common import load_cfg

    cfg = load_cfg(args)
    return run(cfg, args.heatmap, args.no_distortion or cfg.DATASET.NO_DISTORTION)


if __name__ == "__main__":
    main()
