"""Multi-view Human3.6M: the annotation side.

Equivalent of lib/dataset/multiview_h36m_compatible.py:22-234: pickled
annotations, 17 h36m joints mapped into the 16-joint union (with the
thorax/neck, upper-neck/nose, head-top/head renames), grouping by (subject,
action, subaction, image_id) into 4 camera views with ::5 train / ::64
validation subsampling, pseudo-label H5 injection, and PCKh evaluation with
headsize = max(scale) * 200 / 10 at thresholds 0.5/0.4/0.3/0.2/0.1 (mean
over 15 joints, 'head' excluded).
"""

from __future__ import annotations

import collections
import os.path as osp
import pickle

import numpy as np

from posetpu_torch.data.base import JointsDataset, make_u2a_mapping, sorted_union_indices
from posetpu_torch.geometry.cameras import CameraParams

H36M_JOINTS = {
    0: "root", 1: "rhip", 2: "rkne", 3: "rank", 4: "lhip", 5: "lkne",
    6: "lank", 7: "belly", 8: "neck", 9: "nose", 10: "head", 11: "lsho",
    12: "lelb", 13: "lwri", 14: "rsho", 15: "relb", 16: "rwri",
}

SPECIAL_U2A = {"thorax": "neck", "upper neck": "nose", "head top": "head"}

ACTION_NAMES = {
    2: "Direction", 3: "Discuss", 4: "Eating", 5: "Greet", 6: "Phone",
    7: "Photo", 8: "Pose", 9: "Purchase", 10: "Sitting", 11: "SittingDown",
    12: "Smoke", 13: "Wait", 14: "WalkDog", 15: "Walk", 16: "WalkTwo",
}


class MultiViewH36M(JointsDataset):
    def __init__(self, cfg, subset: str, is_train: bool,
                 pseudo_label_path: str = "", no_distortion: bool = False):
        super().__init__(cfg, subset, is_train)
        self.actual_joints = H36M_JOINTS
        self.no_distortion = no_distortion
        self.pseudo_label = bool(pseudo_label_path)
        if self.pseudo_label and not (subset == "train" and is_train):
            raise ValueError("pseudo labels are for the training subset only")

        annot = f"h36m_{subset}{'_nodistortion' if no_distortion else ''}.pkl"
        with open(osp.join(self.root, "h36m", "annot", annot), "rb") as f:
            self.db = pickle.load(f)

        self.u2a_mapping = make_u2a_mapping(self.actual_joints, SPECIAL_U2A)
        self.do_mapping()
        self.grouping = self._get_group()
        self.dataset_type = "multiview_h36m"
        if self.pseudo_label:
            self.add_pseudo(pseudo_label_path)
        self.aug_param_dict = {
            "h36m": {
                "scale_factor": cfg.DATASET.H36M_SCALE_FACTOR,
                "rotation_factor": cfg.DATASET.H36M_ROT_FACTOR,
                "flip": cfg.DATASET.H36M_FLIP,
            }
        }

    def _get_group(self):
        grouping: dict[str, list[int]] = {}
        for i, rec in enumerate(self.db):
            key = "s_{:02}_act_{:02}_subact_{:02}_imgid_{:06}".format(
                rec["subject"], rec["action"], rec["subaction"], rec["image_id"]
            )
            grouping.setdefault(key, [-1, -1, -1, -1])[rec["camera_id"]] = i
        filtered = [v for v in grouping.values() if -1 not in v]
        return filtered[::5] if self.is_train else filtered[::64]

    def add_pseudo(self, path: str) -> None:
        """Inject pseudo 2D labels and visibility from the interchange H5
        (multiview_h36m_compatible.py:109-136). Rows are in
        grouping-flattened order, joints in sorted-union order."""
        from posetpu_torch.data.h5io import load_pseudo_labels

        pseudo_2d, vis = load_pseudo_labels(path)
        pseudo_vis = np.tile(vis[..., None], (1, 1, 3))
        expected = len(self.grouping) * 4
        if len(pseudo_2d) != expected:
            raise ValueError(f"{path}: {len(pseudo_2d)} rows, the grouping has {expected}")

        u = sorted_union_indices(self.u2a_mapping)
        count = 0
        for items in self.grouping:
            for idx in items:
                jp = np.zeros((self.num_joints, 2))
                vp = np.zeros((self.num_joints, 3))
                jp[u] = pseudo_2d[count]
                vp[u] = pseudo_vis[count]
                self.db[idx]["joints_2d_pseudo"] = jp
                self.db[idx]["joints_vis_pseudo"] = vp
                count += 1

    # ------------------------------------------------------------ accessors

    def cameras_flat(self) -> CameraParams:
        """Stacked camera params (CPU tensors) for every grouping-flattened
        record: the input of the batched triangulation and RANSAC."""
        return CameraParams.stack([
            CameraParams.from_dict(self.db[i]["camera"])
            for items in self.grouping for i in items
        ])

    def gt_joints_flat(self, union: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """(joints_2d [N, J, 2], joints_vis [N, J]) in grouping order."""
        flat = [i for items in self.grouping for i in items]
        j = np.array([self.db[i]["joints_2d"] for i in flat], np.float32)
        v = np.array([self.db[i]["joints_vis"] for i in flat], np.float32)[..., 0]
        if union:
            return j, v
        u = sorted_union_indices(self.u2a_mapping)
        return j[:, u], v[:, u]

    def evaluate(self, pred, output_dir=None):
        """2D PCKh at 0.5 (and the 0.4/0.3/0.2/0.1 means) with the headsize
        from the scale (multiview_h36m_compatible.py:184-234). With
        ``output_dir`` the predictions are also drawn
        (utils/vis.save_all_preds)."""
        pred = np.asarray(pred)[:, :, :2].copy()
        u = sorted_union_indices(self.u2a_mapping)
        a = np.array(
            [v for _, v in sorted(
                ((k, v) for k, v in self.u2a_mapping.items() if v != "*")
            )]
        )
        flat = [i for items in self.grouping for i in items]
        gt = np.array([self.db[i]["joints_2d"] for i in flat])[:, u, :2]
        scales = np.array([self.db[i]["scale"] for i in flat])
        headsizes = np.amax(scales, axis=1, keepdims=True) * 200 / 10.0

        dist = np.linalg.norm(gt - pred, axis=2)
        if output_dir is not None:
            from posetpu_torch.utils.vis import save_all_preds

            zip_name = "images_nodistortion.zip@" if self.no_distortion else "images.zip@"
            zip_dir = zip_name if self.data_format == "zip" else ""
            save_all_preds(gt, pred, dist <= headsizes * 0.5, [self.db[i]["image"] for i in flat],
                           "h36m", output_dir,
                           image_root=osp.join(self.root, "h36m", zip_dir, "images"))
        name_values = collections.OrderedDict()
        head_idx = int(np.where(np.array([H36M_JOINTS[x] for x in a]) == "head")[0][0])

        rate = (dist <= headsizes * 0.5).sum(0) / float(gt.shape[0])
        for i in range(len(u)):
            if i == head_idx:
                continue
            name_values[H36M_JOINTS[a[i]]] = rate[i]
        name_values["mean(15j)"] = float(np.mean(np.delete(rate, head_idx)))
        for thr in (0.4, 0.3, 0.2, 0.1):
            r = (dist <= headsizes * thr).sum(0) / float(gt.shape[0])
            name_values[f"mean@{thr:.1f}"] = float(np.mean(np.delete(r, head_idx)))
        return name_values, name_values["mean(15j)"]
