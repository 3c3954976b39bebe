"""The port stands alone: no file of tbz_torch/ (its subpackages
included), and not chip_smoke.py, imports jax or tbz, and a process that
decodes with tbz_torch (one-shot, device-resident, batched over a CPU
mesh, a sharded checksum, a row-gather probe, and through the device
frontend) and uses the rest of its public calls (compress, a
Decompressor, a ZipReader, decompress_file) leaves both out of
sys.modules. Its public names are tbz's."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tbz")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tbz_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_walk_covers_every_subpackage():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    for f in ("tbz_torch/parallel/shard.py", "tbz_torch/parallel/mesh.py",
              "tbz_torch/parallel/distributed.py",
              "tbz_torch/ops/rowgather.py", "tbz_torch/checksums.py",
              "tbz_torch/ops/resolve.py", "tbz_torch/ops/resolve_spans.py",
              "tbz_torch/ops/speculative.py",
              "tbz_torch/ops/tokenize_device.py", "tbz_torch/streaming.py",
              "tbz_torch/deflate_encode.py", "tbz_torch/iosrc.py",
              "tbz_torch/formats/zip_fmt.py"):
        assert f in rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tbz_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_cpu_decode_leaves_jax_and_tbz_unloaded():
    code = (
        "import sys, zlib, gzip\n"
        "import tbz_torch\n"
        "data = bytes(range(256)) * 600\n"
        "assert tbz_torch.decompress(zlib.compress(data, 6),"
        " device='cpu') == data\n"
        "assert tbz_torch.decompress(gzip.compress(data[:5000]),"
        " device='cpu') == data[:5000]\n"
        "out = tbz_torch.decompress(gzip.compress(data), device='cpu',"
        " device_resident=True)\n"
        "assert out.numpy().tobytes() == data\n"
        "from tbz_torch.parallel import distributed, shard\n"
        "from tbz_torch.parallel.mesh import make_mesh\n"
        "m = make_mesh(devices=['cpu'] * 3)\n"
        "assert shard.decode_streams_sharded([zlib.compress(data),"
        " gzip.compress(data)], m) == [data, data]\n"
        "import numpy as np\n"
        "arr = np.frombuffer(data[:3 * 4096], np.uint8)\n"
        "assert shard.make_sharded_adler32(m, len(arr))(arr, 5000) =="
        " zlib.adler32(data[:5000])\n"
        "from tbz_torch.ops import rowgather\n"
        "rowgather.probe('accum', 64, 32, device='cpu')\n"
        "from tbz_torch.utils import config\n"
        "config.set_config(config.Config(frontend='device'))\n"
        "co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)\n"
        "import random\n"
        "big = random.Random(1).randbytes(80000)\n"
        "for p, fmt, want in ((gzip.compress(data[:9000]), 'gzip',"
        " data[:9000]), (co.compress(big) + co.flush(), 'raw', big)):\n"
        "    assert tbz_torch.decompress(p, fmt, device='cpu') == want\n"
        "c = tbz_torch.compress(data, 'gzip', 6)\n"
        "assert gzip.decompress(c) == data\n"
        "d = tbz_torch.Decompressor()\n"
        "head = d.decompress(c[:99])\n"
        "d = tbz_torch.Decompressor.restore(d.checkpoint())\n"
        "assert head + d.decompress(c[99:]) + d.flush() == data\n"
        "w = tbz_torch.ZipWriter()\n"
        "w.write('a', data)\n"
        "assert tbz_torch.ZipReader(w.getvalue(), device='cpu')"
        ".read('a') == data\n"
        "import tempfile\n"
        "with tempfile.NamedTemporaryFile(suffix='.gz') as f:\n"
        "    f.write(c)\n"
        "    f.flush()\n"
        "    assert tbz_torch.decompress_file(f.name, device='cpu') == data\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'tbz')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _all_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["__all__"]):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_public_names_are_tbz_s():
    """Read from the two __init__.py files, so neither package is
    imported here; every name resolves in a process that imports
    tbz_torch alone."""
    mine = _all_names(os.path.join(ROOT, "tbz_torch", "__init__.py"))
    assert mine == _all_names(os.path.join(ROOT, "tbz", "__init__.py"))
    code = ("import sys, tbz_torch\n"
            f"names = {mine!r}\n"
            "assert 'tbz_torch.api' not in sys.modules\n"
            "assert all(callable(getattr(tbz_torch, n)) for n in names)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'tbz')]\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
