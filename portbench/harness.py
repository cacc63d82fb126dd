"""What every cell shares: finding a cell's files by name, the run's
context and record, the program's configuration, the metric readers, and
the checks of the process the result comes from.

A cell is found through ``BENCHMARK.json``: its entry in ``workloads``
names its configuration (``portbench/configs/<config>.json``); its own
parameters are ``portbench/workloads/<cell>.json``, whose ``kind`` names
the driver (``portbench/drivers/<kind>.py``); each metric is read by
``portbench/metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and entries; it edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load: the JAX package and JAX itself
BANNED = ("jax", "jaxlib", "flax", "optax", "posetpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's parameters with its name, its
    configuration) of the cell ``name``."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = {**load_json(root / "portbench" / "workloads" / f"{name}.json"), **entry}
    return bench, cell, load_json(root / conf["file"])


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those that list it, or that list no
    cells and move an end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


@dataclass
class Context:
    """One run: the cell's parameters, its configuration, the seed, the
    window's seconds, whether to trace, the device. ``variant`` is
    ``"program"``, ``"control"`` (the cell's ``control`` switched on), or
    a driver's own reading variant (``"program_int4"``: the serving
    program's 4-bit path);
    ``fault`` names a fault of :mod:`portbench.faults` planted underneath."""

    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    variant: str = "program"
    fault: str | None = None


@dataclass
class Record:
    """What a run measured, for the metric readers. ``iterations`` are
    requests or steps of the window; ``groups`` the four-view groups they
    completed; ``latencies_s`` a served request's each (inf where it
    failed); ``spans_ms`` the benchmark's host spans in the traced
    sub-window by name; ``trace`` that sub-window's profile."""

    kind: str
    cfg: dict
    cell: dict
    setup_s: float = math.nan
    setup_parts: dict = field(default_factory=dict)
    window_s: float = math.nan
    iterations: int = 0
    groups: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: list = field(default_factory=list)
    spans_ms: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: object = None
    memory_peak_bytes: int = 0
    compared: dict = field(default_factory=dict)  # name -> (value, limit)
    correct: bool = False


def program_config(cfg: dict, root: Path = ROOT):
    """The program's configuration object: the cell configuration's YAML
    with its overrides, checked against the sizes the yardstick reads."""
    from posetpu_torch.config import load_config

    pcfg = load_config(str(root / cfg["yaml"]), **cfg["overrides"])
    got = {"num_layers": int(pcfg.POSE_RESNET.NUM_LAYERS),
           "image_size": [int(v) for v in pcfg.NETWORK.IMAGE_SIZE],
           "heatmap_size": [int(v) for v in pcfg.NETWORK.HEATMAP_SIZE],
           "num_joints": int(pcfg.NETWORK.NUM_JOINTS),
           "deconv_filters": [int(v) for v in pcfg.POSE_RESNET.NUM_DECONV_FILTERS],
           "deconv_kernels": [int(v) for v in pcfg.POSE_RESNET.NUM_DECONV_KERNELS],
           "final_conv_kernel": int(pcfg.POSE_RESNET.FINAL_CONV_KERNEL),
           "aggre": bool(pcfg.NETWORK.AGGRE),
           "consistent_loss": bool(pcfg.LOSS.USE_CONSISTENT_LOSS),
           "consistent_loss_weight": float(pcfg.LOSS.CONSISTENT_LOSS_WEIGHT),
           "fundamental_loss": bool(pcfg.LOSS.USE_FUNDAMENTAL_LOSS),
           "target_weight": bool(pcfg.LOSS.USE_TARGET_WEIGHT),
           "fuse_output": bool(pcfg.TEST.FUSE_OUTPUT),
           "optimizer": str(pcfg.TRAIN.OPTIMIZER),
           "lr": float(pcfg.TRAIN.LR),
           "batch_groups": int(pcfg.TRAIN.BATCH_SIZE)}
    wrong = {k: (v, cfg[k]) for k, v in got.items() if v != cfg[k]}
    if wrong:
        raise SystemExit(f"portbench: the program's configuration differs from "
                         f"{cfg['name']}.json: {wrong}")
    return pcfg


def load_weights(module, weights: dict) -> None:
    """Copy the yardstick's weights into the program's module by name;
    every parameter and statistic must be among them."""
    missing, unexpected = module.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise SystemExit(f"portbench: weights by name do not fit the program's module: "
                         f"missing {missing[:5]}, unexpected {unexpected[:5]}")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    """Bytes at the device's allocation peak since :func:`reset_peak`."""
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev) -> None:
    """Return what the dropped objects held to the device."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def loaded_banned() -> list[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))
