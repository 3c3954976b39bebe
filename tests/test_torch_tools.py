"""The port's tools against tbz's: the CLI (`python -m tbz_torch`, in
process and in two subprocesses with --device cpu) against `python -m
tbz`'s bytes and stdlib gzip; debug.dump / dump_tree text; Config's
environment parsing (TBZ_TORCH_PROFILE=0 and 1 among others); the stage
names, calls and bytes of utils.profiling.metrics for the same calls
(fused, declined, host, device-resident, compress); and device_trace
writing a trace on the CPU. Bytes, text and counts: tolerance 0."""

import gzip
import io
import json
import os
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

import tbz
import tbz.__main__ as TM
import tbz_torch
import tbz_torch.__main__ as PM
from tbz import debug as TD
from tbz import huffman as TH
from tbz.utils import config as TC
from tbz.utils import profiling as TP
from tbz_torch import debug as PD
from tbz_torch import huffman as PHF
from tbz_torch.utils import config as PC
from tbz_torch.utils import profiling as PP

from torch_util import corpus, long_code, mixed_blocks, raw_deflate
from torch_util import short_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = corpus(101, 100 << 10)
BIG = corpus(102, 320 << 10)   # bodies of 64 KB and more at level 6


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free tbz's compiled XLA executables after the module (the
    device-backend stage comparisons compile some): each holds hundreds
    of memory maps, under the kernel's limit of 65530 for the suite."""
    yield
    jax.clear_caches()


# --- the CLI ---------------------------------------------------------------

def _files(tmp_path, name="f.txt"):
    pd, td = tmp_path / "port", tmp_path / "tbz"
    pd.mkdir()
    td.mkdir()
    for d in (pd, td):
        (d / name).write_bytes(DATA)
    return os.fspath(pd / name), os.fspath(td / name)


@pytest.mark.parametrize("flags", [[], ["-l", "1"], ["-l", "9"],
                                   ["-l", "6", "--threads", "2"],
                                   ["-f", "zlib", "-l", "3"]])
def test_cli_compress_and_decompress_in_process(tmp_path, flags):
    pf, tf = _files(tmp_path)
    assert PM.main([pf] + flags) == 0 == TM.main([tf] + flags)
    blob = open(pf + ".gz", "rb").read()
    assert blob == open(tf + ".gz", "rb").read()
    fmt = "zlib" if "zlib" in flags else "gzip"
    assert (zlib.decompress(blob) if fmt == "zlib" else
            gzip.decompress(blob)) == DATA
    os.remove(pf)
    assert PM.main(["-d", "--device", "cpu", "-f", fmt, pf + ".gz"]) == 0
    assert open(pf, "rb").read() == DATA


def test_cli_stdout_bench_and_default_device(tmp_path, capsysbinary,
                                             monkeypatch):
    pf, tf = _files(tmp_path)
    gz = gzip.compress(DATA, 6)
    open(pf + ".gz", "wb").write(gz)
    assert PM.main(["-d", "-c", "--bench", "--device", "cpu",
                    pf + ".gz"]) == 0
    out, err = capsysbinary.readouterr()
    assert out == DATA and b"MB/s" in err
    assert PM.main(["-c", "-l", "2", pf]) == 0
    mine = capsysbinary.readouterr().out
    assert TM.main(["-c", "-l", "2", tf]) == 0
    assert mine == capsysbinary.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.main(["-d", "-c", pf + ".gz"])


def test_cli_subprocesses_with_device_cpu(tmp_path, capsysbinary):
    """Two processes: `python -m tbz_torch -c` equals `python -m tbz -c`
    (its main, in this process), and `-d -c --device cpu` from stdin
    gives the data back."""
    pf, tf = _files(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "tbz_torch", "-c", "-l", "6",
                        "--threads", "2", pf], cwd=ROOT, env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert TM.main(["-c", "-l", "6", "--threads", "2", tf]) == 0
    assert r.stdout == capsysbinary.readouterr().out
    r2 = subprocess.run([sys.executable, "-m", "tbz_torch", "-d", "-c",
                         "--device", "cpu"], cwd=ROOT, env=env,
                        input=r.stdout, capture_output=True, timeout=300)
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout == DATA == gzip.decompress(r.stdout)


# --- debug ----------------------------------------------------------------

STREAMS = {
    "mixed": lambda: mixed_blocks(7),
    "short_blocks": lambda: short_blocks(8, 12000),
    "stored": lambda: raw_deflate(corpus(9, 3000), 0),
    "static": lambda: zlib.compress(b"abcabcabcd" * 30)[2:-4],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_dump_text_equals_tbz(name, capsys):
    payload = STREAMS[name]()
    tokens = name != "mixed"
    text = PD.dump(payload, tokens=tokens, out=False)
    assert text == TD.dump(payload, tokens=tokens, out=False)
    assert text.startswith("block 0: ") and "finished=True" in text
    assert capsys.readouterr().out == ""
    PD.dump(payload, tokens=tokens)
    assert capsys.readouterr().out == text


def _tables():
    rng = np.random.default_rng(5)
    lit, dist = PHF.fixed_tables()
    yield lit, PHF.KIND_LITLEN
    yield dist, PHF.KIND_DIST
    for n, kind in ((288, PHF.KIND_LITLEN), (32, PHF.KIND_DIST)):
        lens = long_code(rng, n, 12, eob=n == 288)
        table, err = PHF.build_decode_table(lens, kind)
        assert err == 0
        yield table, kind


def test_dump_tree_text_equals_tbz(capsys):
    for table, kind in _tables():
        PD.dump_tree(table, kind)
        mine = capsys.readouterr().out
        TD.dump_tree(table, kind)
        assert mine == capsys.readouterr().out and mine.count("\n") > 10
        buf = io.StringIO()
        PD.dump_tree(table, kind, out=buf)
        assert buf.getvalue() == mine
    assert TH.root_bits(PHF.KIND_LITLEN) == PHF.root_bits(PHF.KIND_LITLEN)


# --- Config ---------------------------------------------------------------

@pytest.mark.parametrize("value", ["0", "1", "true", "yes", "no", "False",
                                   "TRUE", ""])
def test_profile_env_parses_like_tbz(value, monkeypatch):
    monkeypatch.setenv("TBZ_TORCH_PROFILE", value)
    monkeypatch.setenv("TBZ_PROFILE", value)
    mine = PC.Config.from_env().profile
    assert mine is TC.Config.from_env().profile
    assert mine is (value.lower() in ("1", "true", "yes"))


def test_config_env_types(monkeypatch):
    for k, v in (("LEVEL", "9"), ("MESH_DP", "2"), ("MESH_SP", "1"),
                 ("BACKEND", "host"), ("FRONTEND", "device"),
                 ("PROFILE", "1")):
        monkeypatch.setenv("TBZ_TORCH_" + k, v)
    c = PC.Config.from_env()
    assert (c.level, c.mesh_dp, c.mesh_sp, c.backend, c.frontend,
            c.profile) == (9, 2, 1, "host", "device", True)
    monkeypatch.setenv("TBZ_TORCH_PROFILE", "0")
    assert PC.Config.from_env().profile is False
    assert PC.Config().profile is False


# --- stage timers -----------------------------------------------------------

@pytest.fixture
def profiled():
    """Config.profile on in both packages (default config otherwise),
    both metrics cleared; both restored afterwards."""
    saved = (TC.get_config(), PC.get_config())
    TC.set_config(TC.Config(profile=True))
    PC.set_config(PC.Config(profile=True))
    TP.metrics.reset()
    PP.metrics.reset()
    yield
    TC.set_config(saved[0])
    PC.set_config(saved[1])
    TP.metrics.reset()
    PP.metrics.reset()


def _stages(m):
    return {k: (s.calls, s.bytes) for k, s in m.stages.items()}


def _fixed(data):
    co = zlib.compressobj(6, zlib.DEFLATED, 31, 9, zlib.Z_FIXED)
    return co.compress(data) + co.flush()


# the port's spans nested in decode.fused (tbz has none), in the order
# they close
FUSED_SPANS = ("fused.upload", "fused.scan", "fused.plan", "fused.kernels",
               "fused.meta", "fused.walk", "fused.splice", "fused.fetch")
# the spans each call below runs: the static-only body is declined once
# scanned
NESTED = {"fused_gzip": 8, "fused_zlib_resident": 8, "declined_small": 0,
          "declined_static": 2, "gzip_2member_resident": 8}

# (name, payload, keywords): fused, declined under 64 KB, declined at
# 64 KB and more (static-only: the fused decode takes no candidate)
CALLS = [
    ("fused_gzip", lambda: gzip.compress(BIG, 6), {}),
    ("fused_zlib_resident", lambda: zlib.compress(BIG, 6),
     {"device_resident": True}),
    ("declined_small", lambda: zlib.compress(DATA[:20000], 6), {}),
    ("declined_static", lambda: _fixed(BIG), {}),
    ("gzip_2member_resident", lambda: gzip.compress(BIG) +
     gzip.compress(DATA[:9000]), {"device_resident": True}),
]


@pytest.mark.parametrize("name,make,kw", CALLS, ids=[c[0] for c in CALLS])
def test_stage_names_and_bytes_equal_tbz(profiled, name, make, kw):
    payload = make()
    out = tbz_torch.decompress(payload, device="cpu", **kw)
    theirs = tbz.decompress(payload, backend="device", **kw)
    if kw:
        out, theirs = out.numpy().tobytes(), np.asarray(theirs).tobytes()
    assert out == theirs
    mine = _stages(PP.metrics)
    spans = {k: v for k, v in mine.items() if k.startswith("fused.")}
    top = {k: v for k, v in mine.items() if k not in spans}
    assert top == _stages(TP.metrics)
    assert mine and all(calls > 0 for calls, _ in mine.values())
    k = NESTED[name]
    assert list(spans) == list(FUSED_SPANS[:k])
    for span, (calls, nbytes) in spans.items():
        assert calls == 1
        assert nbytes == (len(BIG) if span in ("fused.splice", "fused.fetch")
                          else top["decode.fused"][1])


def test_host_route_and_compress_stages_equal_tbz(profiled):
    payload = gzip.compress(DATA, 6)
    assert tbz_torch.decompress(payload, backend="host") == \
        tbz.decompress(payload, backend="host")
    c = tbz_torch.compress(DATA, "zlib", 1)
    assert c == tbz.compress(DATA, "zlib", 1)
    mine = _stages(PP.metrics)
    assert mine == _stages(TP.metrics)
    assert set(mine) == {"inflate.host", "verify.crc32", "compress"}
    assert "compress" in PP.metrics.report()


def test_stages_sum_within_the_call_and_are_off_by_default():
    PP.metrics.reset()
    saved = PC.get_config()
    try:
        PC.set_config(PC.Config())
        tbz_torch.decompress(gzip.compress(DATA), device="cpu")
        assert not PP.metrics.stages
        PC.set_config(PC.Config(profile=True))
        import time
        t0 = time.perf_counter()
        tbz_torch.decompress(gzip.compress(DATA), device="cpu")
        call = time.perf_counter() - t0
        total = sum(s.seconds for s in PP.metrics.stages.values())
        assert 0 < total <= call
    finally:
        PC.set_config(saved)
        PP.metrics.reset()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with PP.device_trace(None) as prof:
        assert prof is None
    d = os.fspath(tmp_path / "trace")
    with PP.device_trace(d) as prof:
        out = tbz_torch.decompress(gzip.compress(DATA), device="cpu")
    assert out == DATA
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert len(prof.key_averages()) > 0
