"""On a card: each cell at its own size, a short window, its result line
whole and correct; the control on three seeds not correct. Skips without
a card (python -m pytest benchmark/tests -q -m cuda on the card)."""

import json
import os
import subprocess
import sys

import pytest

import cells
from conftest import ROOT, manifest_cells

CELLS = manifest_cells()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, seed, *extra):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "5", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    r = _run(cell, 2**31 + 77)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    # every end-to-end metric, those from the device's trace too
    names = {m["name"] for m in cells.Cell(cell).end_to_end}
    assert set(r["metrics"]) == names
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**32 + 5, 2**33 + 9])
def test_the_control_is_not_correct_at_full_size(card, cell, seed):
    r = _run(cell, seed, "--control", "verify_off")
    assert not r["correct"]
    assert r["checks"]["probes_accepted"]["value"] >= 1
