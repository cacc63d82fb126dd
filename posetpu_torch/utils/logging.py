"""Logger and output directory layout.

Equivalent of create_logger (lib/utils/utils.py:26-59): a file and console
logger under ``output/<dataset>/<model>/<cfg_name>/`` and a scalar log
directory; also the AverageMeter the reference tracks step metrics with
(function.py:693+). The lines and the ``scalars.jsonl`` records are the JAX
package's.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

from posetpu_torch.config import get_model_name


def create_logger(cfg, cfg_name: str, phase: str = "train"):
    """(logger, final output dir, scalar log dir)."""
    root = Path(cfg.OUTPUT_DIR)
    root.mkdir(parents=True, exist_ok=True)
    dataset = cfg.DATASET.TRAIN_DATASET if phase == "train" else cfg.DATASET.TEST_DATASET
    model_name, _ = get_model_name(cfg)
    cfg_base = os.path.splitext(os.path.basename(cfg_name))[0] if cfg_name else "default"
    final_output_dir = root / dataset / model_name / cfg_base
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = final_output_dir / f"{cfg_base}_{time_str}_{phase}.log"
    logger = logging.getLogger(f"posetpu_torch.{phase}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)

    tb_dir = Path(cfg.LOG_DIR) / dataset / model_name / (cfg_base + "_" + time_str)
    tb_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_dir)


class AverageMeter:
    """Running value and average (reference function.py:693-710)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class ScalarWriter:
    """A tensorboard-style scalar log without tensorboard: one JSON line
    ``{"tag", "value", "step"}`` a scalar in ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
