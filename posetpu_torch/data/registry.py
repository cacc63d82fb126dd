"""Data set registry with the reference's names (lib/dataset/__init__.py:
12-17)."""

from __future__ import annotations

from posetpu_torch.data.coco import COCODataset, COCOMPIIDataset
from posetpu_torch.data.h36m import MultiViewH36M
from posetpu_torch.data.mixed import MixedDataset
from posetpu_torch.data.mpii import MPIIDataset

DATASETS = {
    "mpii": MPIIDataset,
    "multiview_h36m": MultiViewH36M,
    "mixed": MixedDataset,
    "mixed_dataset": MixedDataset,
    "coco": COCODataset,
    "coco_mpii": COCOMPIIDataset,
}


def get_dataset(name: str):
    return DATASETS[name]
