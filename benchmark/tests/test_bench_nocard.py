"""Without a card a run fails and prints no result: it never falls back
to the CPU. So does a run in a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, manifest_cells


def _run(cwd, cell=None):
    cell = cell or manifest_cells()[0]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell,
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def _no_result(r):
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("cell", manifest_cells())
def test_no_card_no_result(cell):
    r = _run(ROOT, cell)
    _no_result(r)
    assert "CUDA card" in r.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
