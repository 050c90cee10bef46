"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every file a cell or a metric names, found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT
from portbench import manifest

BENCH = manifest.load_benchmark()
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert manifest.NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.NAME.match(entry[key])
    if "unit" in entry:
        assert manifest.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    texts = [entry.get("why"), entry.get("layer")]
    if "file" in entry:
        texts.append(entry["source"])
    for text in filter(None, texts):
        assert TEXT.match(text), text

def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    with open(os.path.join(ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["reduced"] == cfg["reduced"]
    assert body["source"] == cfg["source"] or cfg["source"].startswith(
        "https://")
    for key in ("n_samples", "n_snps", "operator_mode", "cohort",
                "structure", "assumed", "limits"):
        assert key in body
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = manifest.Cell(BENCH, w["name"])
    assert cell.chips in (1, 4)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.traffic["metric"] in names
    for name in set(names) - {cell.traffic["metric"], "peak_dev_gb",
                              "setup_s"}:
        assert callable(manifest.reader(name))
    assert cell.per_layer
    moves = {m["moves"] for m in cell.per_layer}
    assert moves <= set(names)
    cohort = manifest.cohort(cell.config["cohort"])
    for group, *work in cohort.products.values():
        assert manifest.NAME.match(group) and len(work) == 5
    kind = manifest.kind(cell.traffic["job"])
    assert callable(kind.run) and callable(kind.judge)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    assert callable(manifest.reader(m["name"]))
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(m):
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry points", "solver", "operators", "kernels",
                      "device"}
