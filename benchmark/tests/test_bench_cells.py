"""A cell is found by name: a new cell, configuration or container
format is new files and new entries, and no file that is there changes.
The traffic generator is the seed's alone."""

import gzip
import hashlib
import json
import os
import shutil
import zlib

import pytest

import cells
import schedule
from conftest import BENCH, LEFT_OUT, ROOT, cpu_scale


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _copy(tmp_path):
    """A copy of the benchmark without its tests, and the digests of
    its files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return _digests(tmp_path / "benchmark")


def test_a_new_cell_loads_with_no_edit(tmp_path):
    before = _copy(tmp_path)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = m["configs"][0]["name"]
    cell = f"{config}.pairs"
    # the new cell: a traffic mix, a workload file, and manifest entries
    (tmp_path / "benchmark/traffic/pairs.json").write_text(json.dumps(
        {"call": "decompress", "kwargs": {"device_resident": True},
         "files_per_call": 1, "probe_every": 8}))
    (tmp_path / f"benchmark/workloads/{cell}.json").write_text(
        json.dumps({"config": config, "traffic": "pairs"}))
    (tmp_path / "benchmark/metrics/pairs_metric.py").write_text(
        "def read(w):\n    return 1.5\n")
    m["workloads"].append({"name": cell, "config": config,
                           "traffic": "pairs", "chips": 1, "why": "a test"})
    # the end-to-end metrics that name no cells: every cell reports them
    every_cell = [x["name"] for x in m["end_to_end"] if "workloads" not in x]
    m["per_layer"].append({"name": "pairs_metric", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": every_cell[0],
                           "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    c = cells.Cell(cell, root=str(tmp_path))
    assert c.config["name"] == config
    assert c.traffic["probe_every"] == 8
    assert c.traffic["kwargs"] == {"device_resident": True}
    assert c.call.setup.__module__ == "benchmark_call_decompress"
    assert [x["name"] for x in c.end_to_end] == every_cell
    # the existing per-layer metrics name their cells; the new one this
    assert [x["name"] for x in c.per_layer] == ["pairs_metric"]
    assert c.reader(c.per_layer[-1]).read(None) == 1.5
    after = _digests(tmp_path / "benchmark")
    assert {k: after[k] for k in before} == before


# a container the harness had no writer for: two gzip members a file
TWO_MEMBERS = '''"""Two gzip members a file: the first half of the data, then
the rest. Each member's check is its trailer."""

import zlib

HEADER, TRAILER = 10, 8


def _member(data, level):
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def _trailer(data):
    return ((zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
            + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))


def _trailers_at(payload):
    out, at = [], 0
    while at < len(payload):
        body = zlib.decompressobj(-15)
        body.decompress(payload[at + HEADER:])
        out.append(len(payload) - len(body.unused_data))
        at = out[-1] + TRAILER
    return out


def write(data, level):
    half = len(data) // 2
    return _member(data[:half], level) + _member(data[half:], level)


def checks(data):
    half = len(data) // 2
    return [_trailer(data[:half]), _trailer(data[half:])]


def holds(payload, values):
    return [payload[a:a + TRAILER] for a in _trailers_at(payload)] == values


def probe(payload):
    at = _trailers_at(payload)[0]
    return payload[:at] + bytes([payload[at] ^ 0xFF]) + payload[at + 1:]
'''


def test_a_new_configuration_is_new_files_only(tmp_path):
    """A configuration in a container the harness could not write, with
    its format module, traffic, cell and metric, all new files and new
    entries: nothing that is there changes, and the cell runs on the
    CPU, correct, while the control is not."""
    before = _copy(tmp_path)
    bench = tmp_path / "benchmark"
    assert not (bench / "formats/gzip_two_members.py").exists()
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(m))
    files = [["a", 40000], ["b", 12000], ["c", 700]]
    new = {
        "formats/gzip_two_members.py": TWO_MEMBERS,
        "configs/halves_gzip6.json": json.dumps(
            {"name": "halves_gzip6", "format": "gzip_two_members",
             "level": 6, "files": files,
             "total_bytes": sum(n for _, n in files),
             "guarantees": {"checksum": "every member's trailer"}}),
        "traffic/halves.json": json.dumps(
            {"call": "decompress", "kwargs": {}, "files_per_call": 1,
             "probe_every": 3}),
        "workloads/halves_gzip6.halves.json": json.dumps(
            {"config": "halves_gzip6", "traffic": "halves"}),
        "metrics/halves_calls.py":
            "def read(w):\n    return len(w.calls)\n",
    }
    for path, text in new.items():
        (bench / path).write_text(text)
    m["configs"].append({"name": "halves_gzip6",
                         "source": "https://www.rfc-editor.org/rfc/rfc1952",
                         "file": "benchmark/configs/halves_gzip6.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "halves_gzip6.halves",
                           "config": "halves_gzip6", "traffic": "halves",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "halves_calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry points",
                           "moves": m["end_to_end"][0]["name"],
                           "workloads": ["halves_gzip6.halves"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = _digests(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(new)
    assert all(m[k][:len(v)] == v for k, v in old.items()
               if isinstance(v, list))

    import run
    c = cells.Cell("halves_gzip6.halves", root=str(tmp_path))
    data = b"abc" * 5000
    payload = c.format.write(data, 6)
    first = zlib.decompressobj(31)
    assert first.decompress(payload) == data[:len(data) // 2]
    assert first.unused_data and gzip.decompress(payload) == data

    scale = cpu_scale(c.config)
    r = run.run_cell(c, 2**35 + 23, 3.0, True, device="cpu", scale=scale)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["answers_checked"]["value"] >= 1
    assert r["checks"]["probes_checked"]["value"] >= 1
    assert r["metrics"]["halves_calls"]["value"] == r["attempted"]
    r = run.run_cell(c, 2**35 + 23, 3.0, False, device="cpu", scale=scale,
                     control="verify_off")
    assert not r["correct"]
    assert r["checks"]["probes_accepted"]["value"] >= 1
    assert r["checks"]["wrong_answers"]["value"] == 0


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
        cells.Cell("no_config.no_traffic")


@pytest.mark.parametrize("traffic", sorted(
    os.path.splitext(f)[0]
    for f in os.listdir(os.path.join(BENCH, "traffic"))))
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
    r = run.run_cell(c, 2**31 + 5, 3.0, True, device="cpu",
                     scale=cpu_scale(c.config))
    assert r["correct"] and r["attempted"] > 1, r["checks"]
    assert r["checks"]["probes_checked"]["value"] >= 1
