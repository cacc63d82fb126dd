"""COCO keypoints, and COCO + MPII.

Equivalent of lib/dataset/coco_compatible.py:29-259 and
coco_mpii_compatible.py:20-74. The COCO JSON is parsed directly, as the JAX
package does (no pycocotools): bbox -> center and scale with the 1.25
padding, the 17 COCO joints partly mapped into the union schema. COCO's
evaluation is commented out in the reference, and raises here.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from posetpu_torch.data.base import JointsDataset, make_u2a_mapping
from posetpu_torch.data.mpii import MPIIDataset

COCO_JOINTS = {
    0: "nose", 1: "left_eye", 2: "right_eye", 3: "left_ear", 4: "right_ear",
    5: "lsho", 6: "rsho", 7: "lelb", 8: "relb", 9: "lwri", 10: "rwri",
    11: "lhip", 12: "rhip", 13: "lkne", 14: "rkne", 15: "lank", 16: "rank",
}


class COCODataset(JointsDataset):
    def __init__(self, cfg, subset: str, is_train: bool, **_):
        super().__init__(cfg, subset, is_train)
        self.actual_joints = COCO_JOINTS
        self.aspect_ratio = float(self.image_size[0]) / self.image_size[1]
        self.db = self._load_db()
        self.u2a_mapping = make_u2a_mapping(self.actual_joints)
        self.do_mapping()
        self.grouping = [
            [i * 4 + j for j in range(4)] for i in range(len(self.db) // 4)
        ]
        self.dataset_type = "coco"
        self.aug_param_dict = {
            "coco": {
                "scale_factor": cfg.DATASET.COCO_SCALE_FACTOR,
                "rotation_factor": cfg.DATASET.COCO_ROT_FACTOR,
                "flip": cfg.DATASET.COCO_FLIP,
            }
        }

    def _box_to_center_scale(self, box):
        """bbox -> center and scale, fitted to the aspect ratio and padded by
        1.25 (coco_compatible.py:228-245)."""
        x, y, w, h = box
        center = np.array([x + w * 0.5, y + h * 0.5], np.float64)
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / 200.0, h / 200.0], np.float64) * 1.25
        return center, scale

    def _load_db(self):
        name = f"person_keypoints_{self.subset}2017.json"
        with open(os.path.join(self.root, "coco", "annotations", name)) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        by_image = defaultdict(list)
        for ann in coco["annotations"]:
            if ann.get("num_keypoints", 0) > 0 and not ann.get("iscrowd", 0):
                by_image[ann["image_id"]].append(ann)

        db = []
        for image_id, anns in by_image.items():
            file_name = images[image_id]["file_name"]
            for ann in anns:
                kp = np.array(ann["keypoints"], np.float64).reshape(-1, 3)
                vis = np.minimum(kp[:, 2], 1)
                joints_vis = np.zeros((17, 3))
                joints_vis[:, 0] = vis
                joints_vis[:, 1] = vis
                center, scale = self._box_to_center_scale(ann["bbox"])
                db.append({
                    "image": os.path.join(f"{self.subset}2017", file_name),
                    "center": center, "scale": scale, "joints_2d": kp[:, :2],
                    "joints_3d": np.zeros((17, 3)), "joints_vis": joints_vis,
                    "source": "coco",
                })
        return db

    def evaluate(self, pred, output_dir=None):
        raise NotImplementedError(
            "COCO evaluation is not wired up (it is commented out in the reference too)")


class COCOMPIIDataset(JointsDataset):
    """COCO's train db, then MPII's (coco_mpii_compatible.py:20-74)."""

    def __init__(self, cfg, subset: str, is_train: bool, **_):
        super().__init__(cfg, subset, is_train)
        self.coco = COCODataset(cfg, "train", is_train)
        self.mpii = MPIIDataset(cfg, "train", is_train)
        self.db = self.coco.db + self.mpii.db
        offset = len(self.coco.db)
        self.grouping = self.coco.grouping + [
            [i + offset for i in g] for g in self.mpii.grouping
        ]
        self.u2a_mapping = self.mpii.u2a_mapping
        self.dataset_type = "coco_mpii"
        self.aug_param_dict = {**self.coco.aug_param_dict, **self.mpii.aug_param_dict}
