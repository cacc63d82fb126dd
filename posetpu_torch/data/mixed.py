"""Mixed MPII + multi-view H36M.

Equivalent of lib/dataset/mixed_dataset_compatible.py:20-78: the h36m db,
then the mpii db with its groups re-indexed past it, and each source's
augmentation. The reference's ``IF_SAMPLE`` weighted sampling is
unimplemented there (utils.py:119-126); here :meth:`group_weights` gives the
loader's per-group weights, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from posetpu_torch.data.base import JointsDataset
from posetpu_torch.data.h36m import MultiViewH36M
from posetpu_torch.data.mpii import MPIIDataset


class MixedDataset(JointsDataset):
    def __init__(self, cfg, subset: str, is_train: bool,
                 pseudo_label_path: str = "", no_distortion: bool = False):
        super().__init__(cfg, subset, is_train)
        self.h36m = MultiViewH36M(cfg, "train", is_train,
                                  pseudo_label_path=pseudo_label_path,
                                  no_distortion=no_distortion)
        self.mpii = MPIIDataset(cfg, "train", is_train)

        self.db = self.h36m.db + self.mpii.db
        offset = len(self.h36m.db)
        self.grouping = self.h36m.grouping + [
            [i + offset for i in g] for g in self.mpii.grouping
        ]
        self.u2a_mapping = self.h36m.u2a_mapping
        # the pseudo-label substitution applies to the h36m records alone
        # (load_record tests the record's source)
        self.pseudo_label = self.h36m.pseudo_label
        self.no_distortion = no_distortion
        self.dataset_type = "mixed"
        self.aug_param_dict = {**self.h36m.aug_param_dict, **self.mpii.aug_param_dict}

    def group_weights(self, cfg) -> np.ndarray:
        """Per-group sampling weights (H36M_WEIGHT, MPII_WEIGHT: the
        reference's IF_SAMPLE intent, utils.py:119-126)."""
        w = np.empty(len(self.grouping), np.float64)
        w[: len(self.h36m)] = float(cfg.DATASET.H36M_WEIGHT)
        w[len(self.h36m):] = float(cfg.DATASET.MPII_WEIGHT)
        return w

    def evaluate(self, pred, output_dir=None):
        raise NotImplementedError("evaluate per-source datasets instead")
