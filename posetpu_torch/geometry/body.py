"""16-joint MPII-order skeleton tree (lib/multiviews/body.py:11-57)."""

from __future__ import annotations

import numpy as np

JOINT_NAMES = [
    "rank", "rkne", "rhip", "lhip", "lkne", "lank", "root", "thorax",
    "upper neck", "head top", "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
]

CHILDREN = [
    [], [0], [1], [4], [5], [], [2, 3, 7], [8, 12, 13], [9], [],
    [], [10], [11], [14], [15], [],
]

ROOT_IDX = 6


def edges() -> list[tuple[int, int]]:
    """(parent, child) pairs in node order."""
    return [(i, c) for i, ch in enumerate(CHILDREN) for c in ch]


def nodes_by_level_desc() -> list[int]:
    """Node indices sorted deepest-first (leaves before parents): the
    traversal order of the reference's sort_skeleton_by_level, with its
    argsort-then-reverse order among nodes of one level."""
    level = np.zeros(len(JOINT_NAMES))
    queue = [ROOT_IDX]
    while queue:
        cur = queue.pop(0)
        for c in CHILDREN[cur]:
            level[c] = level[cur] + 1
            queue.append(c)
    return list(np.argsort(level)[::-1])


class HumanBody:
    """Object facade matching the reference's HumanBody API."""

    def __init__(self):
        self.skeleton = [
            {"idx": i, "name": JOINT_NAMES[i], "children": CHILDREN[i]}
            for i in range(len(JOINT_NAMES))
        ]
        self.skeleton_sorted_by_level = [self.skeleton[i] for i in nodes_by_level_desc()]
        self.root_idx = ROOT_IDX
