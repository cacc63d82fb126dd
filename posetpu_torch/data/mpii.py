"""MPII (single-view, grouped by four to take the multi-view batch shape).

Equivalent of lib/dataset/mpii_compatible.py:22-193: JSON annotations with
the matlab 1-based fixups (center y + 15 s, scale x1.25, minus one), flat
images grouped four at a time into "views", and PCKh@0.5 against the
``gt_<subset>.mat`` head boxes scaled by 0.6.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np

from posetpu_torch.data.base import JointsDataset, make_u2a_mapping, sorted_union_indices

MPII_JOINTS = {
    0: "rank", 1: "rkne", 2: "rhip", 3: "lhip", 4: "lkne", 5: "lank",
    6: "root", 7: "thorax", 8: "upper neck", 9: "head top", 10: "rwri",
    11: "relb", 12: "rsho", 13: "lsho", 14: "lelb", 15: "lwri",
}


class MPIIDataset(JointsDataset):
    def __init__(self, cfg, subset: str, is_train: bool, **_):
        super().__init__(cfg, subset, is_train)
        self.actual_joints = MPII_JOINTS
        self.db = self._load_db()
        self.u2a_mapping = make_u2a_mapping(self.actual_joints)
        self.do_mapping()
        self.grouping = [
            [i * 4 + j for j in range(4)] for i in range(len(self.db) // 4)
        ]
        self.dataset_type = "mpii"
        self.aug_param_dict = {
            "mpii": {
                "scale_factor": cfg.DATASET.MPII_SCALE_FACTOR,
                "rotation_factor": cfg.DATASET.MPII_ROT_FACTOR,
                "flip": cfg.DATASET.MPII_FLIP,
            }
        }

    def _load_db(self):
        path = os.path.join(self.root, "mpii", "annot", f"{self.subset}.json")
        with open(path) as f:
            anno = json.load(f)
        db = []
        for a in anno:
            c = np.array(a["center"], np.float64)
            s = np.array([a["scale"], a["scale"]], np.float64)
            if c[0] != -1:  # avoid cropping limbs (mpii_compatible.py:84-87)
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # matlab 1-based

            joints = np.zeros((16, 2))
            joints_vis = np.zeros((16, 3))
            if self.subset != "test":
                joints = np.array(a["joints"], np.float64)
                joints[:, :2] -= 1
                vis = np.array(a["joints_vis"], np.float64)
                joints_vis[:, 0] = vis
                joints_vis[:, 1] = vis
            db.append({
                "image": a["image"], "center": c, "scale": s, "joints_2d": joints,
                "joints_3d": np.zeros((16, 3)), "joints_vis": joints_vis, "source": "mpii",
            })
        return db

    def evaluate(self, pred, output_dir=None):
        """PCKh@0.5 against the gt_<subset>.mat head boxes
        (mpii_compatible.py:139-193). pred [N, J_u, >=2] in source-image
        pixels, rows in grouping-flattened order. With ``output_dir`` the
        predictions are also drawn (utils/vis.save_all_preds)."""
        pred = np.asarray(pred)[:, :, :2].copy()
        gt_file = os.path.join(self.root, "mpii", "annot", f"gt_{self.subset}.mat")
        from scipy.io import loadmat

        headboxes = loadmat(gt_file)["headboxes_src"]
        headsizes = np.linalg.norm(headboxes[1] - headboxes[0], axis=0) * 0.6

        u = sorted_union_indices(self.u2a_mapping)
        a = np.array(
            [v for _, v in sorted(
                ((k, v) for k, v in self.u2a_mapping.items() if v != "*")
            )]
        )

        flat = [i for items in self.grouping for i in items]
        gt = np.array([self.db[i]["joints_2d"] for i in flat])[:, u, :2]
        vis = np.array([self.db[i]["joints_vis"] for i in flat])[:, u, 0]
        scale = headsizes[flat][:, None]

        dist = np.linalg.norm(gt - pred, axis=2)
        detected = (dist / scale) <= 0.5
        considered = detected * vis
        rate = considered.sum(0) / vis.sum(0).astype(np.float32)

        if output_dir is not None:
            from posetpu_torch.utils.vis import save_all_preds

            names = [self.db[i]["image"] for i in flat]
            zip_dir = "images.zip@" if self.data_format == "zip" else ""
            save_all_preds(gt, pred, detected, names, "mpii", output_dir,
                           image_root=os.path.join(self.root, "mpii", zip_dir, "images"))

        name_values = collections.OrderedDict(
            (MPII_JOINTS[a[i]], rate[i]) for i in range(len(u))
        )
        joint_ratio = vis.sum(0) / vis.sum()
        name_values["mean"] = float(np.sum(joint_ratio * rate))
        return name_values, name_values["mean"]
