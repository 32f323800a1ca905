"""Every cell, configuration and metric of BENCHMARK.json loads by name,
the file keeps to the benchmark's contract, and a cell, a configuration
and a metric are added as new files and entries alone."""

import filecmp
import json
import re
import shutil

import pytest

from benchmark import common
from benchmark.run import reported

SPEC = common.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    runs = 2 + 14 * 24      # a full check with 24 cells
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    w = common.workload(SPEC, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    assert cell == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
    config = common.config_file(SPEC, w["config"])
    traffic = common.traffic_file(w["traffic"])
    limits = common.cell_file(cell)["limits"]
    assert {"unet", "dae", "format"} <= set(config) and limits
    assert hasattr(common.entry(traffic["entry"]), "Session")
    e2e = {m["name"] for m in reported(SPEC, cell, 0)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reported(SPEC, cell, 1)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_has_a_reader(metric):
    assert callable(common.metric_reader(metric))


def test_entries_keep_to_the_contract():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        names.add(c["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= set(CELLS)
    for name in CELLS + METRICS + sorted(names):
        assert NAME.match(name), name
    assert len(set(METRICS)) == len(METRICS) and len(set(CELLS)) == len(CELLS)


def test_a_cell_a_configuration_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gets a new configuration (a copy of
    ref_scale at batch 2), a traffic mix, a cell and a per-layer metric as
    new files and BENCHMARK.json entries; every file that was there stays
    as it was, and the new cell and metric load by name."""
    root = tmp_path
    shutil.copytree(common.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    here = root / "benchmark"
    (here / "configs" / "ref_scale_copy.json").write_text(
        (here / "configs" / "ref_scale.json").read_text())
    traffic = common.traffic_file("generate_b16")
    (here / "traffic" / "generate_b2.json").write_text(json.dumps(dict(traffic, batch=2,
                                                                       check_rows=2)))
    (here / "cells" / "ref_scale_copy.generate_b2.json").write_text(
        json.dumps({"limits": {"latents": 0.1}}))
    (here / "metrics" / "requests.serve.py").write_text(
        "def read(run):\n    return run['window']['requests']\n")
    spec["configs"].append(dict(spec["configs"][0], name="ref_scale_copy",
                                file="benchmark/configs/ref_scale_copy.json"))
    spec["workloads"].append({"name": "ref_scale_copy.generate_b2", "config": "ref_scale_copy",
                              "traffic": "generate_b2", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "requests.serve", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "pipeline",
                              "moves": "clip_s", "workloads": ["ref_scale_copy.generate_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = "ref_scale_copy.generate_b2"
    w = common.workload(spec, cell)
    assert common.config_file(spec, w["config"], root)["unet"]["mlp_groups"] == 8
    assert common.traffic_file(w["traffic"], here)["batch"] == 2
    assert common.cell_file(cell, here)["limits"] == {"latents": 0.1}
    assert [m["name"] for m in reported(spec, cell, 1)] == ["requests.serve"]
    assert common.metric_reader("requests.serve", here)({"window": {"requests": 3}}) == 3
    # nothing that was there changed
    diff = filecmp.dircmp(common.HERE, here, ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + [f for sub in d.subdirs.values() for f in changed(sub)]
    assert changed(diff) == []
