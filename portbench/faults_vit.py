"""Faults planted underneath a ViTPose training run, for the check that
``correct`` comes out false and for the readings that set the limits
(``portbench.readings --variant fault:<name>``). Each wraps an object of
the program; none is used by a benchmark run.

- ``attention_unscaled``: every block's attention without its ``1 /
  sqrt(d)`` (``softmax(q k^T) v``), set where the program's attention
  reads its scale;
- ``layer_decay_skipped``: every parameter steps at the unscaled rate, the
  optimizer's layer-wise scales all 1.

The faults of :mod:`portbench.faults` that touch no ResNet module
(``unchanged``, ``half_batch``, ``stats_unchanged``, ``bank_unchanged``)
plant as there.
"""

from __future__ import annotations

from portbench import faults

TRAIN = ("attention_unscaled", "layer_decay_skipped")
SHARED = ("unchanged", "half_batch", "stats_unchanged", "bank_unchanged")


def train_step(fault, step, tx, model):
    """A train step with a training fault planted (``tx`` and ``model`` the
    step's optimizer and module, before its first step)."""
    if fault == "attention_unscaled":
        for blk in model.backbone.blocks:
            blk.attn.scale = 1.0
        return step
    if fault == "layer_decay_skipped":
        tx.lr_scale = lambda name: 1.0
        return step
    if fault in SHARED:
        return faults.train_step(fault, step, tx, model)
    raise ValueError(f"unknown ViTPose training fault {fault!r}")
