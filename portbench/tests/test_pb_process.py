"""The harness as a process: no card, no program, no JAX."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "flashpca_tpu"}


def run_py(code: str, cwd: str = ROOT, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args, "-c", code], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=600)


def last_json(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "wide500k.pca20", "--seed", str(2**31 + 11),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0
    assert last_json(p.stdout) is None


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "wide500k.pca20", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert last_json(p.stdout) is None


def test_a_run_and_its_reference_import_no_jax():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import run_tiny\n"
        "run_tiny('tall1m.pca20')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = run_py(code)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "flashpca_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    p = run_py("import sys, json; import portbench.reference, "
               "portbench.roofline, portbench.gen; "
               "print(json.dumps(sorted({m.split('.')[0] "
               "for m in sys.modules})))")
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"flashpca_tpu_torch"})


def test_forbidden_names_compared_whole():
    from portbench import run

    sys.modules.setdefault("flashpca_tpu_torch_fake", sys)
    try:
        assert "flashpca_tpu" not in run.forbidden_modules() or \
            "flashpca_tpu" in {m.split(".")[0] for m in sys.modules}
    finally:
        sys.modules.pop("flashpca_tpu_torch_fake", None)
