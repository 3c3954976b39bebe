"""Finding a cell's pieces by name.

`BENCHMARK.json` (at the root of the checkout) names each cell's
configuration and traffic mix, and which metrics it reports. Every
other piece is a file of its own under `benchmark/`, found by its name:

    configs/<config>.json     a configuration: its files' sizes, format
                              and level, and the guarantees it states
    formats/<format>.py       a container format, named by a
                              configuration's `format`: `write(data,
                              level)` gives one file's payload as that
                              format's writer writes it; `checks(data)`
                              the values its checks hold for the data,
                              computed with stdlib zlib alone;
                              `holds(payload, values)` whether a
                              payload's checks hold them; `probe(payload)`
                              the payload with a check broken, which the
                              program has to reject
    traffic/<traffic>.json    a traffic mix: the call, its arguments,
                              the order of the files, the probes
    workloads/<cell>.json     the cell: its configuration and traffic
    calls/<call>.py           how one call drives the program
    metrics/<metric>.py       the reader of one metric

So a later cell, configuration, container format, traffic mix or
metric is added as new files and new entries, with no edit to a file
that is there. A format module imports nothing of the program.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# modules that no run may load: JAX, and the JAX package (`tbz`) and its
# benchmark (`bench.py`), compared by the top-level name whole
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "tbz", "bench"))


def forbidden_modules(modules) -> list:
    """The names in `modules` whose top-level name is forbidden."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def format_module(name: str, root: str = ROOT):
    """The module of container format `name`: formats/<name>.py."""
    return _module(os.path.join(root, "benchmark", "formats", f"{name}.py"),
                   "benchmark_format_" + name.replace(".", "_"))


class Cell:
    """One cell: its entry in the manifest, its configuration and its
    container format, its traffic, the metrics it reports and their
    readers."""

    def __init__(self, name: str, root: str = ROOT):
        here = os.path.join(root, "benchmark")
        manifest = _json(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        own = _json(os.path.join(here, "workloads", f"{name}.json"))
        for key in ("config", "traffic"):
            if own[key] != self.entry[key]:
                raise ValueError(f"{name}: workloads/{name}.json gives "
                                 f"{key} {own[key]!r}, BENCHMARK.json "
                                 f"{self.entry[key]!r}")
        self.config = _json(os.path.join(here, "configs",
                                         f"{own['config']}.json"))
        self.format = format_module(self.config["format"], root)
        self.traffic = _json(os.path.join(here, "traffic",
                                          f"{own['traffic']}.json"))
        self.call = _module(os.path.join(here, "calls",
                                         f"{self.traffic['call']}.py"),
                            f"benchmark_call_{self.traffic['call']}")

        def mine(m):
            return name in m.get("workloads", (name,))

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]
        self._here = here

    def reader(self, metric: dict):
        """The module that reads `metric` (its `read(window)` gives the
        value, or None where the run has nothing to read)."""
        return _module(os.path.join(self._here, "metrics",
                                    f"{metric['name']}.py"),
                       "benchmark_metric_" + metric["name"].replace(".", "_"))
