"""The harness finds every part by name, ``BENCHMARK.json`` agrees with the
parts on disk, and a new cell or metric is found with no other edit."""

import json
import os
import re

import pytest

from perfbench.lib import harness, registry

with open(os.path.join(registry.REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = registry.cell(cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    registry.config(c["config"])
    assert hasattr(registry.traffic(c["traffic"]), "run")
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = registry.metric(metric)
    assert {k: entry[k] for k in ("unit", "better", "source", "layer", "moves")} == {
        "unit": mod.UNIT, "better": mod.BETTER, "source": mod.SOURCE, "layer": mod.LAYER,
        "moves": mod.MOVES}
    assert entry["workloads"] == [w for w in mod.WORKLOADS
                                  if w in {c["name"] for c in BENCH["workloads"]}]
    # every cell it lists reports the end-to-end metric it moves
    e2e = next(e for e in BENCH["end_to_end"] if e["name"] == mod.MOVES)
    assert set(entry["workloads"]) <= set(e2e.get("workloads", entry["workloads"]))


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(registry.REPO, c["file"]))
        assert registry.config(c["name"])["source"] == c["source"]
        assert registry.config(c["name"])["reduced"] == c["reduced"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" and "workloads" not in e for e in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_parts_on_disk_are_the_ones_the_benchmark_runs():
    """Every cell and metric file is one that ``BENCHMARK.json`` names, and
    every configuration file one of its cells uses."""
    assert registry.names("cells") == sorted(w["name"] for w in BENCH["workloads"])
    assert registry.names("metrics") == sorted(m["name"] for m in BENCH["per_layer"])
    assert registry.names("configs") == sorted(c["name"] for c in BENCH["configs"])


def test_new_cell_and_metric_need_only_new_files(tmp_path):
    """A cell file and a metric file dropped into a copy are found, and
    the metric is read in that cell, with no other edit."""
    import shutil

    pb = tmp_path / "perfbench"
    shutil.copytree(registry.ROOT, pb, ignore=shutil.ignore_patterns("__pycache__"))
    cell = registry.cell("rico25-uncond-b1024", str(pb))
    cell.update(name="rico25-uncond-b64", batch=64)
    (pb / "cells" / "rico25-uncond-b64.json").write_text(json.dumps(cell))
    (pb / "metrics" / "chains.sample.py").write_text(
        'NAME = "chains.sample"\nUNIT = "chains"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nLAYER = "reverse chain"\nMOVES = "layouts_per_s"\n'
        'WORKLOADS = ["rico25-uncond-b64"]\n\n\ndef read(run):\n'
        '    return run["counters"].get("chains")\n')
    assert "rico25-uncond-b64" in registry.names("cells", str(pb))
    assert registry.cell("rico25-uncond-b64", str(pb))["batch"] == 64
    found = registry.metrics_of("rico25-uncond-b64", str(pb))
    assert [m.NAME for m in found] == ["chains.sample"]
    assert found[0].read({"counters": {"chains": 3}}) == 3
    assert "chains.sample" not in [m.NAME for m in registry.metrics_of("rico25-uncond-b1024",
                                                                          str(pb))]


def test_judge_needs_a_limit_for_every_number():
    assert harness.judge({"a": 0.5}, {"a": 1.0}) == [("a", 0.5, 1.0, True)]
    assert harness.judge({"a": float("inf")}, {"a": 1.0})[0][3] is False
    with pytest.raises(KeyError):
        harness.judge({"b": 0.0}, {"a": 1.0})
