"""H5 interchange files: the stage boundary between 2D inference and the 3D
pseudo-label, triangulation and RPSM stages. The schemas are the
reference's, so the JAX package and this one read each other's files:

* heatmap dump ``heatmaps_locations_<subset>_<type>.h5``:
  ``heatmaps [N*4, J_u, h, w]``, ``locations [N*4, J_u, 3]`` (x, y, maxval),
  ``joint_names_order`` (sorted union indices), lib/core/function.py:671-676;
* pseudo labels ``<thre>_<k>_pseudo_label.h5``: ``pseudo_2d [N*4, J_u, 2]``,
  ``joints_vis [N*4, J_u]``, run/test/test_pseudo_label.py:213-216, 255-258.

``h5py`` is imported where a file is read or written, so the package imports
where it is absent.
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    """Whether h5py is installed: the train and validate CLIs write their
    heatmap dump only then (and say so when they do not)."""
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def save_heatmaps(path: str, heatmaps, locations, joint_names_order) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f["heatmaps"] = np.asarray(heatmaps, np.float32)
        f["locations"] = np.asarray(locations, np.float32)
        f["joint_names_order"] = np.asarray(joint_names_order)


def load_heatmaps(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return (np.array(f["heatmaps"]), np.array(f["locations"]),
                np.array(f["joint_names_order"]))


def save_pseudo_labels(path: str, pseudo_2d, joints_vis) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f["pseudo_2d"] = np.asarray(pseudo_2d, np.float32)
        f["joints_vis"] = np.asarray(joints_vis, np.float32)


def load_pseudo_labels(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return np.array(f["pseudo_2d"]), np.array(f["joints_vis"])
