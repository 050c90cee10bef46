"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<traffic>.json``).  The configuration
names its cohort, ``portbench/cohorts/<cohort>.py``: a ``Cohort(config,
seed, device, cpu_kernels)`` that makes the data from the seed and
builds the program's operators on it (``op``; ``wide`` for
``check()``; ``operators()`` to wrap; ``products``, the table of their
products' work), and gives the float64 reference's products on the same
data.  The traffic mix names its job kind, ``portbench/kinds/<job>.py``:
a ``Kind(traffic, cohort, control)`` whose ``run(i, rec)`` runs job
``i`` through the program's entry points and whose ``judge(jobs,
limits)`` holds the window's answers to the reference.  A per-layer
metric, and an end-to-end one other than the traffic's time a job, the
peak and the set-up, is read by ``portbench/metrics/<metric name>.py``,
whose ``read(run)`` returns a number or None.  A later cell, configuration,
cohort, job kind, traffic mix or metric is new files and new entries,
never an edit of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def config_path(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def code_path(folder: str, name: str) -> str:
    return os.path.join(HERE, folder, f"{name}.py")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with its configuration, traffic mix
    and metrics."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        self.config = _json(config_path(w["config"]))
        self.traffic = _json(traffic_path(w["traffic"]))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def module(folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", code_path(folder, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` function of a per-layer metric's file."""
    return module("metrics", metric).read


def cohort(name: str):
    """The ``Cohort`` class of a configuration's cohort file."""
    return module("cohorts", name).Cohort


def kind(name: str):
    """The ``Kind`` class of a traffic mix's job kind file."""
    return module("kinds", name).Kind
