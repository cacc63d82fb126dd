"""Data set registry with the reference's names (lib/dataset/__init__.py:
12-17). The image data sets are not ported yet (ROADMAP A4b)."""

from __future__ import annotations

from posetpu_torch.data.h36m import MultiViewH36M

DATASETS = {"multiview_h36m": MultiViewH36M}

NOT_PORTED = ("mpii", "mixed", "mixed_dataset", "coco", "coco_mpii")


def get_dataset(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"data set {name!r} is not ported yet (ROADMAP A4b)")
    return DATASETS[name]
