"""No run loads JAX or the JAX package, and the plain reference loads
nothing of the program: checked in fresh processes, the top-level module
names compared whole (``posetpu_torch`` is not ``posetpu``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

RUN = """
import json, sys
sys.path.insert(0, {tests!r})
from portbench_tiny import run_tiny
from portbench import harness
rec = run_tiny({cell!r})
print(json.dumps({{"banned": harness.loaded_banned(), "attempted": rec.attempted}}))
"""

YARDSTICK = """
import json, sys
import portbench.reference.model, portbench.reference.serve, portbench.reference.train
import portbench.counts, portbench.weights, portbench.traffic
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_a_run_loads_no_jax(cell):
    got = json.loads(_python(RUN.format(tests=str(harness.HERE / "tests"), cell=cell)))
    assert got["attempted"] > 0 and got["banned"] == []


def test_the_reference_loads_nothing_of_the_program():
    tops = set(json.loads(_python(YARDSTICK)))
    assert not tops & {"posetpu_torch", *harness.BANNED}


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "posetpu_torch_fake", sys)
    assert "posetpu" not in harness.loaded_banned()
    monkeypatch.setitem(sys.modules, "posetpu.config", sys)
    assert "posetpu" in harness.loaded_banned()
