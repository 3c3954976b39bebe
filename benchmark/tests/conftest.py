"""CPU tests of the benchmark (python -m pytest benchmark/tests -q).
Tests that need a card carry the `cuda` marker and skip without one,
decided inside the test."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


# cells whose files are all under benchmark/ but which BENCHMARK.json
# leaves out for their spread (PERF.md §7); the tests run them too
LEFT_OUT = [
    {"name": "canterbury_zlib6.bodies", "config": "canterbury_zlib6",
     "traffic": "bodies", "chips": 1, "why": "left out for its spread"},
    {"name": "silesia_gzip6.batch", "config": "silesia_gzip6",
     "traffic": "batch", "chips": 1, "why": "left out for its spread"},
]


# the largest file a configuration's CPU run holds: the plain versions
# decode a file of about this size at once
CPU_LARGEST_FILE = 50_000


def cpu_scale(cfg: dict) -> float:
    """The one rule for the scale at which these tests run a
    configuration on the CPU: its largest file cut to about
    CPU_LARGEST_FILE bytes, to one significant digit, and never grown.
    It reads the configuration's own file sizes alone."""
    largest = max(n for _, n in cfg["files"])
    return min(1.0, float(f"{CPU_LARGEST_FILE / largest:.1g}"))


def manifest_cells():
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def traffic_of(cell: str) -> dict:
    """The traffic mix of `cell` (of the manifest or LEFT_OUT), read from
    its workload file."""
    import json
    with open(os.path.join(BENCH, "workloads", f"{cell}.json")) as f:
        name = json.load(f)["traffic"]
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def cell_root(tmp_path_factory):
    """A copy of the benchmark whose manifest also holds LEFT_OUT."""
    import json
    import shutil
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"] += LEFT_OUT
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return str(root)
