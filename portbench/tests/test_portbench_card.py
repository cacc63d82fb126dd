"""On the chip, at each cell's own sizes: a short run of the command comes
out correct, and the cell's control (its lower precision) comes out not
correct on three seeds. Skipped where there is no CUDA device; on the
chip: ``python3 -m pytest -q -m gpu portbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2**32 + 17), "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    _, params, cfg = harness.cell_files(cell)
    drv = harness.driver(params["kind"])
    for seed in (2**32 + 101, 2**32 + 102, 2**32 + 103):
        ctx = harness.Context(cell=params, cfg=cfg, seed=seed, seconds=3.0, trace=False,
                              device=card, t_start=time.perf_counter(), variant="control")
        rec = drv.control(ctx) if hasattr(drv, "control") else drv.run(ctx)
        assert not rec.correct, (seed, rec.compared)
        harness.free(card)
