"""BENCHMARK.json and the files it names: every cell, configuration,
driver and metric resolves by name, names and units keep to their
alphabet, and a new cell, configuration and metric come in as files and
entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_keys_and_alphabet():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    bench, params, cfg = harness.cell_files(cell)
    assert params["kind"] in ("serve", "train")
    drv = harness.driver(params["kind"])
    assert callable(drv.run)
    assert cfg["name"] == params["config"]
    e2e = harness.metrics_for(bench, cell, trace=False)
    layer = harness.metrics_for(bench, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_file_is_in_the_benchmark():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert names == files


def test_a_cell_configuration_and_metric_come_in_as_files(tmp_path):
    """A copy of the benchmark takes a new configuration, cell and
    per-layer metric as new files and new entries; nothing else changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_json(harness.HERE / "configs" / "r50_256_fusion.json")
    cfg["name"] = "r50_256_fusion_copy"
    (root / "portbench/configs/r50_256_fusion_copy.json").write_text(json.dumps(cfg))
    cell = harness.load_json(harness.HERE / "workloads" / "train.r50_256_fusion.json")
    cell["groups"] = 16
    (root / "portbench/workloads/train.dummy.json").write_text(json.dumps(cell))
    (root / "portbench/metrics/groups.train.py").write_text(
        "def read(rec):\n    return float(rec.groups) if rec.kind == 'train' else None\n")
    bench["configs"].append({"name": "r50_256_fusion_copy", "source": "https://example.org",
                             "file": "portbench/configs/r50_256_fusion_copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "train.dummy", "config": "r50_256_fusion_copy",
                               "traffic": "half", "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "groups.train", "unit": "groups", "better": "higher",
                               "source": "program_counter", "layer": "whole step",
                               "moves": "train_groups_per_s"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index(
        "train_groups_per_s")]["workloads"].append("train.dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got, params, conf = harness.cell_files("train.dummy", root)
    assert params["groups"] == 16 and conf["name"] == "r50_256_fusion_copy"
    names = [m["name"] for m in harness.metrics_for(got, "train.dummy", trace=True)]
    assert "groups.train" in names and "mfu.train" not in names
    # a per-layer metric that lists no cells reaches every cell that reports what it moves
    assert "groups.train" in [m["name"] for m in
                              harness.metrics_for(got, "train.r50_256_fusion", trace=True)]
    rec = harness.Record(kind="train", cfg=conf, cell=params, groups=48)
    assert harness.reader("groups.train", root)(rec) == 48.0
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()
             if p.name != "BENCHMARK.json"}
    assert all(after[k] == v for k, v in before.items())
