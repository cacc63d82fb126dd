"""The union joint set shared by every dataset, and its left/right flip pairs."""

from __future__ import annotations

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
