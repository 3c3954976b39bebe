"""No run loads JAX or the JAX package: the check compares each module's
top-level name whole, so `tbz_torch` passes and `tbz` does not."""

import json
import os
import subprocess
import sys

import cells
from conftest import BENCH, LEFT_OUT, ROOT, cpu_scale, manifest_cells


def test_top_level_names_are_compared_whole():
    assert cells.forbidden_modules(["tbz_torch", "tbz_torch.api",
                                    "jaxtyping", "benchmark_call_x",
                                    "tbzx"]) == []
    assert cells.forbidden_modules(["tbz", "tbz.api", "jax._src.core",
                                    "jaxlib", "flax.linen", "bench"]) == \
        ["bench", "flax.linen", "jax._src.core", "jaxlib", "tbz", "tbz.api"]


# everything a run loads on the CPU: the harness, every cell run once at
# a small size, traced (its call module, readers and the program's
# stages)
_PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import run, cells
for name, scale in {cells_!r}.items():
    c = cells.Cell(name, root={cell_root!r})
    run.run_cell(c, 7, 0.5, True, device="cpu", scale=scale)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_neither_jax_nor_tbz(cell_root):
    names = manifest_cells() + [w["name"] for w in LEFT_OUT]
    scales = {n: cpu_scale(cells.Cell(n, root=cell_root).config)
              for n in names}
    code = _PROBE.format(root=ROOT, bench=BENCH, cells_=scales,
                         cell_root=cell_root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert "tbz_torch" in loaded and "torch" in loaded
    assert cells.forbidden_modules(loaded) == []


def test_no_source_of_the_benchmark_imports_them():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py") or f.startswith("test_bench_imports"):
                continue
            with open(os.path.join(d, f)) as fh:
                for line in fh:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        top = words[1].split(".")[0].rstrip(",")
                        assert top not in cells.FORBIDDEN, (f, line)
