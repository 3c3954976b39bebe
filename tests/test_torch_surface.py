"""tbz_torch's public surface holds tbz's, read from the source with
`ast` (importing tbz would compile XLA executables, and neither package
is imported here):

- every module of tbz/ has a counterpart file in tbz_torch/;
- every public top-level function and class of a tbz module, and every
  entry of its __all__, has a counterpart of the same name: a def, a
  class, an assignment, an import alias, or a name the module's
  __getattr__ serves (tbz_torch/__init__.py's lazy imports);
- every parameter of a public function, of a public class (its
  __init__'s, or its fields for a dataclass or NamedTuple) and of a
  class's public methods exists in the counterpart (an import alias is
  followed to the def it names).

DEPARTURES lists what the port leaves out on purpose, one line and one
reason each: the parts of tbz that exist only for JAX or the TPU.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (tbz module, name or "function(parameter)" / "function(*)") -> reason
DEPARTURES = {
    ("parallel/mesh.py", "dp_spec"):
        "a JAX PartitionSpec over the stream axis; the port's Mesh places "
        "rows on its entries explicitly (parallel/shard.py)",
    ("parallel/mesh.py", "NamedSharding"):
        "re-export of jax.sharding.NamedSharding",
    ("parallel/mesh.py", "P"):
        "re-export of jax.sharding.PartitionSpec",
    ("checksums.py", "crc32_device(lane_bytes)"):
        "lane tiling of tbz's XLA CRC-32; csrc/crc32.cu has its own",
    ("checksums.py", "crc32_device_tail(lane_bytes)"):
        "lane tiling of tbz's XLA CRC-32; csrc/crc32.cu has its own",
    ("checksums.py", "adler32_device(chunk)"):
        "chunk of tbz's XLA Adler-32; csrc/adler32.cu has its own tiling",
    ("checksums.py", "adler32_device_tail(chunk)"):
        "chunk of tbz's XLA Adler-32; csrc/adler32.cu has its own tiling",
    ("ops/tokenize_device.py", "build_flat_table(*)"):
        "tbz's XLA version makes one table a call (lens, entry_const, "
        "n_syms, allow_single, emu: the TPU gather emulation); the port's "
        "kernel builds a plan's B litlen and distance tables in one launch",
    ("ops/batched.py", "Plan(bound)"):
        "size of tbz's one bounded D2H (metadata and a token prefix) over "
        "a TPU host link; the port fetches the metadata, then exactly the "
        "compacted tokens",
    ("ops/batched.py", "Plan(covered)"):
        "lane-covered bits, read only to size Plan.bound",
    ("utils/config.py", "Config(min_out_capacity)"):
        "padding bucket bounding jit recompiles",
    ("utils/config.py", "Config(pow2_buckets)"):
        "padding buckets bounding jit recompiles",
    ("utils/config.py", "Config(crc_lane_bytes)"):
        "lane tiling of tbz's XLA CRC-32 (lane_bytes above)",
    ("utils/config.py", "Config(adler_chunk)"):
        "chunk of tbz's XLA Adler-32 (chunk above)",
    ("utils/config.py", "Config(window_bytes)"):
        "read nowhere in tbz; the DEFLATE window is constants.MAX_WINDOW",
    ("utils/config.py", "Config(trace_dir)"):
        "output directory of jax.profiler; the port's "
        "profiling.device_trace takes its directory as an argument, as "
        "tbz's does",
}


def _modules(pkg: str) -> dict:
    base = os.path.join(ROOT, pkg)
    out = {}
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                p = os.path.join(d, n)
                out[os.path.relpath(p, base).replace(os.sep, "/")] = p
    return out


TBZ, PORT = _modules("tbz"), _modules("tbz_torch")


def _top_level(tree):
    """Top-level statements, those inside top-level if/try included."""
    todo = list(tree.body)
    while todo:
        n = todo.pop(0)
        if isinstance(n, (ast.If, ast.Try)):
            todo += n.body + n.orelse + getattr(n, "finalbody", [])
            todo += [s for h in getattr(n, "handlers", []) for s in h.body]
        else:
            yield n


class _Module:
    def __init__(self, path: str):
        self.names = {}          # name -> its defining node
        self.all = []
        self.lazy = set()        # names __getattr__ serves
        for n in _top_level(ast.parse(open(path, encoding="utf-8").read(),
                                      path)):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                self.names[n.name] = n
                if n.name == "__getattr__":
                    self.lazy = {c.value for c in ast.walk(n)
                                 if isinstance(c, ast.Constant)
                                 and isinstance(c.value, str)}
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target]):
                    for x in ast.walk(t):
                        if isinstance(x, ast.Name):
                            self.names[x.id] = n
                            if x.id == "__all__":
                                self.all = list(ast.literal_eval(n.value))
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for a in n.names:
                    self.names[(a.asname or a.name).split(".")[0]] = n

    def public(self) -> list:
        defs = [k for k, v in self.names.items() if not k.startswith("_")
                and isinstance(v, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))]
        return defs + [a for a in self.all if a not in defs]

    def has(self, name: str) -> bool:
        return name in self.names or (name in self.all
                                      and name in self.lazy)


def _resolve(mod: _Module, rel: str, name: str):
    """The def or class `name` stands for in the port's module `rel`,
    following a relative `from .x import y as name`; None for anything
    else."""
    node = mod.names.get(name)
    if isinstance(node, ast.ImportFrom) and node.level:
        src = [a.name for a in node.names if (a.asname or a.name) == name][0]
        parts = rel.split("/")[:-1]
        parts = parts[:len(parts) - (node.level - 1)]
        target = "/".join(parts + (node.module or "").split("."))
        for cand in (target + ".py", target + "/__init__.py"):
            if cand in PORT:
                return _resolve(_Module(PORT[cand]), cand, src)
        return None
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return node
    return None


def _params(node) -> list:
    if isinstance(node, ast.ClassDef):
        init = [m for m in node.body if isinstance(m, ast.FunctionDef)
                and m.name == "__init__"]
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        return (_params(init[0])[1:] if init else []) + fields
    a = node.args
    ps = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return ps + [f"*{x.arg}" for x in (a.vararg, a.kwarg) if x]


def _callables(node):
    """(qualified name, node) of a public def or class and of a class's
    public methods."""
    yield node.name, node
    if isinstance(node, ast.ClassDef):
        for m in node.body:
            if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")):
                yield f"{node.name}.{m.name}", m


def _method(cls, name: str):
    for m in cls.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and m.name == name:
            return m
    return None


def missing(rel: str) -> list:
    """Every key of the port's surface missing against tbz's module
    `rel`: "module" for the file, a name, or "function(parameter)"
    (the keys of DEPARTURES, less the module)."""
    if rel not in PORT:
        return ["module"]
    t, p = _Module(TBZ[rel]), _Module(PORT[rel])
    out = []
    for name in t.public():
        if not p.has(name):
            out.append(name)
            continue
        node = t.names.get(name)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            continue
        mine = _resolve(p, rel, name)
        if mine is None:
            continue
        for qual, fn in _callables(node):
            other = mine if qual == name else _method(mine,
                                                      qual.split(".")[1])
            if other is None:
                out.append(qual)
                continue
            have = set(_params(other))
            out += [f"{qual}({x})" for x in _params(fn) if x not in have]
    return out


def undeclared(rel: str) -> list:
    """missing(rel) less the departures DEPARTURES declares."""
    return [k for k in missing(rel) if (rel, k) not in DEPARTURES
            and (rel, k.split("(")[0] + "(*)") not in DEPARTURES]


@pytest.mark.parametrize("rel", sorted(TBZ))
def test_module_has_a_counterpart(rel):
    assert rel in PORT, f"tbz/{rel} has no tbz_torch/{rel}"


@pytest.mark.parametrize("rel", sorted(TBZ))
def test_public_surface_matches_tbz(rel):
    bad = undeclared(rel)
    assert not bad, f"tbz_torch/{rel} lacks {bad} of tbz/{rel}"


def test_departures_are_real():
    """Each declared departure names a part of tbz that the port
    really lacks (so the table cannot go stale), with a reason."""
    for (rel, key), reason in DEPARTURES.items():
        assert rel in TBZ and reason, (rel, key)
        miss = missing(rel)
        if key.endswith("(*)"):
            fn = key[:-3]
            assert any(k.startswith(fn + "(") for k in miss), (rel, key)
        else:
            assert key in miss, (rel, key)


def test_reads_without_importing_either_package():
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import test_torch_surface as s\n"
            "bad = {r: s.undeclared(r) for r in s.TBZ if s.undeclared(r)}\n"
            "assert not bad, bad\n"
            "loaded = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'tbz', 'tbz_torch', 'torch')]\n"
            "assert not loaded, loaded\n"
            "print(len(s.TBZ))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) == len(TBZ)
