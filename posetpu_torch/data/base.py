"""The multi-view joints data set's host side: the union joint set shared by
every data set, its left/right flip pairs, the mapping of a data set's joints
into it, and the record processing of the reference's
JointsDatasetCompatible (lib/dataset/joints_dataset_compatible.py:29-253).

The host does only the variable-shape work: decode, augmentation draws, the
crop warp to the fixed input size and the photometric jitter, into uint8
crops and joint arrays. Normalisation and the Gaussian targets run batched
on the device (data/prepare.py). cv2 is imported where an image is decoded,
so the annotation side runs where it is absent.
"""

from __future__ import annotations

import os.path as osp
from typing import Any

import numpy as np

from posetpu_torch.data import zipreader

UNION_JOINTS = {
    0: "rank", 1: "rkne", 2: "rhip", 3: "lhip", 4: "lkne", 5: "lank",
    6: "root", 7: "thorax", 8: "upper neck", 9: "head top", 10: "rwri",
    11: "relb", 12: "rsho", 13: "lsho", 14: "lelb", 15: "lwri",
}

FLIP_PAIR_NAMES = [
    ["rank", "lank"], ["rkne", "lkne"], ["rhip", "lhip"],
    ["rwri", "lwri"], ["relb", "lelb"], ["rsho", "lsho"],
]


def union_flip_pairs() -> list[tuple[int, int]]:
    names = list(UNION_JOINTS.values())
    return [tuple(names.index(n) for n in pair) for pair in FLIP_PAIR_NAMES]


def make_u2a_mapping(actual_joints: dict, special: dict | None = None) -> dict:
    """union index -> actual index ('*' where the data set lacks the joint),
    with the reference's special renames (multiview_h36m_compatible.py:
    92-107)."""
    union_values = list(UNION_JOINTS.values())
    mapping = {k: "*" for k in UNION_JOINTS}
    for a_idx, name in actual_joints.items():
        if name in union_values:
            mapping[union_values.index(name)] = a_idx
    for u_name, a_name in (special or {}).items():
        a_idx = list(actual_joints.keys())[list(actual_joints.values()).index(a_name)]
        mapping[union_values.index(u_name)] = a_idx
    return mapping


def sorted_union_indices(u2a_mapping: dict) -> np.ndarray:
    """The union indices a data set has, sorted: the 'u' array of the H5
    dumps and of evaluation (function.py:665-668)."""
    pairs = sorted((k, v) for k, v in u2a_mapping.items() if v != "*")
    return np.array([k for k, _ in pairs])


def _affine_matrix_np(center, scale, rot, out_size):
    """The forward crop matrix [2, 3] for cv2.warpAffine (float64 numpy, the
    host's twin of ops/affine.get_affine_transform)."""
    box_w = scale[0] * 200.0
    out_w, out_h = float(out_size[0]), float(out_size[1])
    s = out_w / box_w
    rad = np.deg2rad(rot)
    cs, sn = np.cos(rad), np.sin(rad)
    a = np.array([[s * cs, s * sn], [-s * sn, s * cs]], np.float64)
    t = np.array([out_w * 0.5, out_h * 0.5]) - a @ np.asarray(center, np.float64)
    return np.concatenate([a, t[:, None]], axis=1)


def _color_jitter(img_bgr, rs: np.random.RandomState):
    """Photometric jitter approximating the reference's torchvision chain
    (brightness (0.7, 3), contrast (0.5, 2), saturation (0.5, 2), hue 0.2
    on the RGB image, joints_dataset_compatible.py:67-71), in an order drawn
    from ``rs``."""
    import cv2

    img = img_bgr.astype(np.float32)
    for op in rs.permutation(4):
        if op == 0:
            img = img * rs.uniform(0.7, 3.0)
        elif op == 1:
            mean = img.mean()
            img = (img - mean) * rs.uniform(0.5, 2.0) + mean
        elif op == 2:
            gray = img.mean(axis=2, keepdims=True)
            img = (img - gray) * rs.uniform(0.5, 2.0) + gray
        else:
            hsv = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_BGR2HSV
            ).astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] + rs.uniform(-0.2, 0.2) * 180.0) % 180.0
            img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


class JointsDataset:
    """A flat record db with 4-view grouping, remapped into the union joint
    schema, and its records processed into fixed-shape arrays."""

    def __init__(self, cfg, subset: str, is_train: bool):
        self.cfg = cfg
        self.subset = subset
        self.is_train = is_train
        self.root = cfg.DATASET.ROOT
        self.data_format = cfg.DATASET.DATA_FORMAT
        self.image_size = np.array(cfg.NETWORK.IMAGE_SIZE)
        self.heatmap_size = np.array(cfg.NETWORK.HEATMAP_SIZE)
        self.sigma = cfg.NETWORK.SIGMA
        self.color_jitter = bool(cfg.DATASET.COLOR_JITTER)
        self.num_joints = 16
        self.flip_pairs = union_flip_pairs()
        self.db: list[dict] = []
        self.grouping: list[list[int]] = []
        self.pseudo_label = False
        self.no_distortion = False
        self.aug_param_dict: dict[str, dict] = {}
        self.u2a_mapping: dict = {}
        self.dataset_type = "base"

    def do_mapping(self) -> None:
        """Remap the actual-joint arrays into the union schema
        (joints_dataset_compatible.py:73-87)."""
        union_idx = [k for k, v in self.u2a_mapping.items() if v != "*"]
        actual_idx = [v for v in self.u2a_mapping.values() if v != "*"]
        for item in self.db:
            joints = np.zeros((self.num_joints, 2))
            vis = np.zeros((self.num_joints, 3))
            joints[union_idx] = np.asarray(item["joints_2d"])[actual_idx]
            vis[union_idx] = np.asarray(item["joints_vis"])[actual_idx]
            item["joints_2d"] = joints
            item["joints_vis"] = vis

    def __len__(self) -> int:
        return len(self.grouping)

    # ------------------------------------------------------------- get item

    def _image_path(self, rec: dict) -> str:
        source = rec["source"]
        if source == "h36m" and self.no_distortion:
            zip_name = "images_nodistortion.zip@"
        else:
            zip_name = "images.zip@"
        image_dir = zip_name if self.data_format == "zip" else ""
        if source == "coco":
            image_dir = ""
        return osp.join(self.root, source, image_dir, "images", rec["image"])

    def load_record(self, idx: int, rs: np.random.RandomState,
                    defer_image: bool = False) -> dict[str, Any]:
        """Process one db record into fixed-shape arrays (the device-free
        part of joints_dataset_compatible.__getitem__:111-201).

        The augmentation (scale, rotation, flip) is drawn from ``rs`` here,
        then one integer that seeds the record's own jitter stream, so
        ``rs`` advances the same whether the image work runs now or later.
        With ``defer_image=True`` the image work is left undone: the record
        carries an ``_image_job`` that :meth:`finalize_record` completes (the
        loader runs a batch's jobs on its thread pool)."""
        rec = self.db[idx]
        if rec["source"] == "h36m" and self.pseudo_label:
            joints = np.array(rec["joints_2d_pseudo"][:, :2], np.float64)
            vis = np.array(rec["joints_vis_pseudo"][:, 0], np.float64)
        else:
            joints = np.array(rec["joints_2d"][:, :2], np.float64)
            vis = np.array(rec["joints_vis"][:, 0], np.float64)

        center = np.array(rec["center"], np.float64).copy()
        scale = np.array(rec["scale"], np.float64).copy()
        rotation = 0.0

        aug = self.aug_param_dict.get(rec["source"])
        do_flip = False
        if self.is_train and rec["source"] != "h36m" and aug is not None:
            sf, rf = aug["scale_factor"], aug["rotation_factor"]
            scale = scale * np.clip(rs.randn() * sf + 1, 1 - sf, 1 + sf)
            rotation = (
                np.clip(rs.randn() * rf, -rf * 2, rf * 2)
                if rs.random_sample() <= 0.6
                else 0.0
            )
            do_flip = bool(aug["flip"] and rs.random_sample() <= 0.5)

        jitter_rs = (
            np.random.RandomState(rs.randint(1 << 31))
            if self.color_jitter else None
        )

        # h36m samples without pseudo labels train with zero weight
        # (joints_dataset_compatible.py:250-251)
        supervise = not (rec["source"] == "h36m" and not self.pseudo_label)
        out = {
            "supervise": np.float32(supervise),
            "scale": scale.astype(np.float32),
            "rotation": np.float32(rotation),
            "joints_2d": np.asarray(rec["joints_2d"], np.float32),
            "is_h36m": np.float32(rec["source"] == "h36m"),
            "subject": np.int32(rec.get("subject", -1) if rec["source"] == "h36m" else -1),
            "_image_job": {
                "path": self._image_path(rec), "joints": joints, "vis": vis,
                "center": center, "scale": scale, "rotation": rotation,
                "do_flip": do_flip, "jitter_rs": jitter_rs,
            },
        }
        if not defer_image:
            self.finalize_record(out)
        return out

    def finalize_record(self, out: dict) -> None:
        """Complete a record: decode, flip, warp and jitter its image (cv2,
        which releases the GIL while it works), and its crop-frame joints.
        Records do not share state, so the loader runs this on a thread
        pool. A file that is missing or does not decode raises
        FileNotFoundError naming its path."""
        job = out.pop("_image_job")
        warped, joints, vis, center, trans = self._python_load(job)
        self._finish_record(out, warped, joints, vis, center, trans, job["jitter_rs"])

    def _python_load(self, state):
        """cv2 / zip image path: decode, optional flip, warp."""
        import cv2

        joints, vis = state["joints"], state["vis"]
        center = state["center"]
        img = zipreader.imread(
            state["path"], cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
        )
        if state["do_flip"]:
            img = img[:, ::-1, :]
            joints, vis = self._flip_joints(joints, vis, img.shape[1])
            center = center.copy()
            center[0] = img.shape[1] - center[0] - 1
        trans = _affine_matrix_np(
            center, state["scale"], state["rotation"], self.image_size
        )
        warped = cv2.warpAffine(
            img,
            trans,
            (int(self.image_size[0]), int(self.image_size[1])),
            flags=cv2.INTER_LINEAR,
        )
        return warped, joints, vis, center, trans

    def _finish_record(self, out, warped, joints, vis, center, trans, jitter_rs):
        if jitter_rs is not None:
            warped = _color_jitter(warped, jitter_rs)
        visible = vis > 0
        j_t = joints.copy()
        if visible.any():
            homo = np.concatenate([joints[visible], np.ones((visible.sum(), 1))], 1)
            j_t[visible] = homo @ trans.T
        out["image"] = warped  # uint8 BGR [H, W, 3]
        out["joints_crop"] = j_t.astype(np.float32)
        out["joints_vis"] = vis.astype(np.float32)
        out["center"] = center.astype(np.float32)

    def _flip_joints(self, joints, vis, width):
        """fliplr_joints semantics (transforms.py:50-64) on [J, 2] / [J]."""
        joints = joints.copy()
        vis = vis.copy()
        joints[:, 0] = width - joints[:, 0] - 1
        for a, b in self.flip_pairs:
            joints[[a, b]] = joints[[b, a]]
            vis[[a, b]] = vis[[b, a]]
        return joints * (vis > 0)[:, None], vis

    def load_group(self, group_idx: int, rs: np.random.RandomState,
                   defer_images: bool = False) -> list[dict]:
        return [
            self.load_record(i, rs, defer_image=defer_images)
            for i in self.grouping[group_idx]
        ]

    def evaluate(self, preds, output_dir=None):
        raise NotImplementedError
