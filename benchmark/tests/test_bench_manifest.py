"""BENCHMARK.json against the benchmark's contract, and every piece a
cell names present under benchmark/."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sum(n for _, n in cfg["files"]) == cfg["total_bytes"]
        assert cfg["guarantees"]
        assert os.path.exists(os.path.join(BENCH, "formats",
                                           f"{cfg['format']}.py"))


def test_cells(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        with open(os.path.join(BENCH, "workloads",
                               f"{w['name']}.json")) as f:
            own = json.load(f)
        assert (own["config"], own["traffic"]) == (w["config"], w["traffic"])
        with open(os.path.join(BENCH, "traffic",
                               f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "calls",
                                           f"{traffic['call']}.py"))


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = manifest["end_to_end"]
    per = manifest["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    reports = {c: set() for c in cells}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for c in m.get("workloads", cells):
            reports[c].add(m["name"])
    assert all(len(r) >= 2 and "setup_s" in r for r in reports.values())
    layers = {}
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {x["name"] for x in e2e}
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(any(c in m.get("workloads", cells) for m in per)
               for c in cells)
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
