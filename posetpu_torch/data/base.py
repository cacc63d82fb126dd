"""The union joint set shared by every dataset, its left/right flip pairs,
the mapping of a data set's joints into it, and the annotation side of the
multi-view joints data set."""

from __future__ import annotations

import numpy as np

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


class JointsDataset:
    """The annotation side of the reference's JointsDatasetCompatible
    (lib/dataset/joints_dataset_compatible.py:29-253): a flat record db
    with 4-view grouping, remapped into the union joint schema. Image
    loading, augmentation and target rendering are not ported yet."""

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
