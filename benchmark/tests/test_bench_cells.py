"""A cell is found by name: a new cell is new files and new entries, and
no file that is there changes. The traffic generator is the seed's
alone."""

import hashlib
import json
import os
import shutil

import pytest

import cells
import schedule
from conftest import BENCH, LEFT_OUT, ROOT


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_loads_with_no_edit(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(tmp_path / "benchmark")
    # the new cell: a traffic mix, a workload file, and manifest entries
    (tmp_path / "benchmark/traffic/pairs.json").write_text(json.dumps(
        {"call": "decompress", "kwargs": {"device_resident": True},
         "files_per_call": 1, "probe_every": 8}))
    (tmp_path / "benchmark/workloads/canterbury_zlib6.pairs.json") \
        .write_text(json.dumps({"config": "canterbury_zlib6",
                                "traffic": "pairs"}))
    (tmp_path / "benchmark/metrics/pairs_metric.py").write_text(
        "def read(w):\n    return 1.5\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "canterbury_zlib6.pairs",
                           "config": "canterbury_zlib6", "traffic": "pairs",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "pairs_metric", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "decode_GBps",
                           "workloads": ["canterbury_zlib6.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    c = cells.Cell("canterbury_zlib6.pairs", root=str(tmp_path))
    assert c.config["name"] == "canterbury_zlib6"
    assert c.traffic["probe_every"] == 8
    assert c.traffic["kwargs"] == {"device_resident": True}
    assert c.call.setup.__module__ == "benchmark_call_decompress"
    assert [x["name"] for x in c.end_to_end] == ["decode_GBps", "setup_s"]
    # the existing per-layer metrics name their cells; the new one this
    assert [x["name"] for x in c.per_layer] == ["pairs_metric"]
    assert c.reader(c.per_layer[-1]).read(None) == 1.5
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


def test_every_cell_loads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    for w in m["workloads"]:
        c = cells.Cell(w["name"])
        assert c.chips == 1 and c.config["name"] == w["config"]
        for metric in c.end_to_end + c.per_layer:
            assert callable(c.reader(metric).read)


def test_a_cell_not_in_the_manifest_is_refused():
    with pytest.raises(KeyError):
        cells.Cell("silesia_gzip6.nothing")


@pytest.mark.parametrize("traffic", ["stream", "bodies", "batch"])
def test_schedule_is_the_seeds(traffic):
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    n = 12

    def take(seed, k):
        g = schedule.calls(t, n, seed)
        return [next(g) for _ in range(k)]

    seed = 2**40 + 17
    a = take(seed, 400)
    assert a == take(seed, 400)
    assert a != take(seed + 1, 400)
    every = t["probe_every"]
    for i in range(0, 400 - every + 1, every):
        assert sum(p is not None for _, p in a[i:i + every]) == 1
    if t["files_per_call"] == "all":
        assert all(sorted(f) == list(range(n)) for f, _ in a)
    else:
        for r in range(0, 396, n):
            assert sorted(f[0] for f, _ in a[r:r + n]) == list(range(n))
    assert schedule.warm(t, n) == ([list(range(n))]
                                   if t["files_per_call"] == "all"
                                   else [[f] for f in range(n)])


@pytest.mark.parametrize("name", [w["name"] for w in LEFT_OUT])
def test_a_left_out_cell_is_one_manifest_entry_away(cell_root, name):
    """The cells left out for their spread (PERF.md §7) have every file
    they need: with their entries in the manifest alone they run, here on
    the CPU at a small size, traced, and come out correct."""
    import run
    c = cells.Cell(name, root=cell_root)
    scale = {"silesia_gzip6": 0.003, "canterbury_zlib6": 0.05}
    r = run.run_cell(c, 2**31 + 5, 3.0, True, device="cpu",
                     scale=scale[c.config["name"]])
    assert r["correct"] and r["attempted"] > 1, r["checks"]
    assert r["checks"]["probes_checked"]["value"] >= 1
