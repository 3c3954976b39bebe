"""The BGZF configuration (SAMv1 §4.1): its published sizes, its files
as stdlib's gzip reads them with every block's BC field, its probe
caught by the reference, and its call's set-up refusing a program that
cannot read BGZF."""

import gzip
import json
import os
import zlib

import pytest

import cells
import corpus
import reference
from conftest import BENCH

BGZF = cells.format_module("bgzf")


def _config():
    with open(os.path.join(BENCH, "configs", "bam_bgzf6.json")) as f:
        return json.load(f)


def _members(payload: bytes) -> list:
    """Each member of a gzip payload as (header fields, extra, body,
    trailer), parsed with stdlib zlib alone."""
    out, at = [], 0
    while at < len(payload):
        assert payload[at:at + 4] == b"\x1f\x8b\x08\x04"   # FEXTRA only
        mtime = int.from_bytes(payload[at + 4:at + 8], "little")
        xfl, os_ = payload[at + 8], payload[at + 9]
        xlen = int.from_bytes(payload[at + 10:at + 12], "little")
        extra = payload[at + 12:at + 12 + xlen]
        d = zlib.decompressobj(-15)
        data = d.decompress(payload[at + 12 + xlen:])
        end = len(payload) - len(d.unused_data) + 8
        out.append(((mtime, xfl, os_), extra, data, payload[end - 8:end],
                    end - at))
        at = end
    return out


def test_the_published_sizes():
    cfg = _config()
    assert cfg["format"] == "bgzf" and cfg["level"] == 6
    assert cfg["block_bytes"] == BGZF.BLOCK == 65280 == 0xFF00
    assert cfg["blocks_per_file"] == 4096
    assert [n for _, n in cfg["files"]] == [4096 * 65280] * 4
    assert cfg["total_bytes"] == 1_069_547_520 == 4 * 267_386_880
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        m = json.load(f)
    (entry,) = [c for c in m["configs"] if c["name"] == "bam_bgzf6"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"]) == [
        "blocks_per_file"]


@pytest.mark.parametrize("name", ["kernels_roofline", "copy_ms_per_MiB",
                                  "device_idle_pct", "decode_GBps"])
def test_the_cells_readers_are_the_accepted_ones(name):
    """Each metric the manifest gives the cell under a name of its own
    (`<name>.bgzf`, `<name>.file`) reads with the accepted reader."""
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        m = json.load(f)
    (own,) = [e["name"] for e in m["per_layer"]
              if e["name"].split(".")[0] == name
              and e.get("workloads") == ["bam_bgzf6.file"]]
    from test_bench_metrics import trace, window
    base = cells._module(os.path.join(BENCH, "metrics", f"{name}.py"),
                         "base_" + name)
    mine = cells._module(os.path.join(BENCH, "metrics", f"{own}.py"),
                         "own_" + own.replace(".", "_"))
    assert mine.read.__module__ == "benchmark_metric_" + name
    w = window(trace(), 3.35e12)
    assert mine.read(w) is not None and mine.read(w) == base.read(w)


@pytest.mark.parametrize("size", [0, 1, 65279, 65280, 65281,
                                  3 * 65280 + 17])
def test_stdlib_reads_the_file_and_every_block_carries_bc(size):
    data = corpus.make_file(2**31 + 3, 0, size)
    payload = BGZF.write(data, 6)
    assert gzip.decompress(payload) == data
    members = _members(payload)
    assert len(members) == -(-size // 65280) + 1
    for k, (fields, extra, block, trailer, length) in enumerate(members):
        assert fields == (0, 0, 255)
        # XLEN 6: SI1 66, SI2 67, SLEN 2, BSIZE = the member's size less 1
        assert extra == b"BC\x02\x00" + (length - 1).to_bytes(2, "little")
        assert block == data[k * 65280:(k + 1) * 65280]
        assert trailer == ((zlib.crc32(block) & 0xFFFFFFFF)
                           .to_bytes(4, "little")
                           + len(block).to_bytes(4, "little"))
    assert payload.endswith(BGZF.EOF) and len(BGZF.EOF) == 28
    assert members[-1][2] == b""


def test_random_blocks_fit_their_bsize():
    """Incompressible data: each block, stored by zlib, still fits BSIZE's
    16 bits."""
    import numpy as np
    data = np.random.default_rng(5).integers(0, 256, 2 * 65280,
                                             dtype=np.uint8).tobytes()
    payload = BGZF.write(data, 6)
    assert gzip.decompress(payload) == data
    assert all(n <= 65536 for *_, n in _members(payload))


@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_the_probe_is_caught(blocks):
    data = corpus.make_file(7, 1, blocks * 65280 - 100)
    payload = BGZF.write(data, 6)
    bad = BGZF.probe(payload)
    assert len(bad) == len(payload)
    diff = [i for i in range(len(payload)) if bad[i] != payload[i]]
    assert len(diff) == 1
    # the middle member's CRC-32 (the first of two), never the EOF block
    trailers = [sum(m[-1] for m in _members(payload)[:k + 1]) - 8
                for k in range(blocks + 1)]
    assert diff == [trailers[(blocks + 1 - 1) // 2]]
    with pytest.raises((OSError, zlib.error)):
        gzip.decompress(bad)
    ref = reference.Reference(BGZF, [data])
    assert ref.expect(0, payload) == data
    assert ref.expect(0, bad) is reference.CHECKSUM_ERROR


def test_the_set_up_refuses_a_program_that_cannot_read_bgzf(monkeypatch):
    from tbz_torch import errors
    from tbz_torch.parallel import shard
    call = cells._module(os.path.join(BENCH, "calls", "decode_bgzf_file.py"),
                         "benchmark_call_decode_bgzf_file")
    got = call.setup("cpu", {"format": "bgzf"})([BGZF.write(b"abc", 6)])
    assert got == [b"abc"]

    def unknown(payloads, mesh, **kw):
        raise errors.DeflateError("invalid block type 3")

    monkeypatch.setattr(shard, "decode_streams_sharded", unknown)
    with pytest.raises(RuntimeError, match="cannot read BGZF"):
        call.setup("cpu", {"format": "bgzf"})
