"""Whole BGZF files (SAMv1 §4.1) through the batch route,
tbz_torch.parallel.shard.decode_streams_sharded, on a one-entry CPU mesh
(the plain versions of kernels 5-7): members cut to their own bytes,
split by BSIZE and tokenized in the pool, every disagreement sent back to
the in-order parse, launches of at most MAX_ROWS rows, and the spans of
`decode.batch`. Held to stdlib zlib block by block, to the in-order
parse, and to tbz's decode_streams_sharded (which reads a BGZF file as
multi-member gzip) where tbz runs it. Bytes: tolerance 0."""

import concurrent.futures
import contextlib
import dataclasses
import gzip
import threading
import time
import zlib

import jax
import numpy as np
import pytest

from tbz.parallel import shard as TS
from tbz.parallel.mesh import make_mesh
from tbz_torch import errors as PE
from tbz_torch import frontend as PFE
from tbz_torch.parallel import shard as PS
from tbz_torch.parallel.mesh import make_mesh as port_mesh
from tbz_torch.utils import config as PC
from tbz_torch.utils import profiling as PP

from torch_util import BGZF_BLOCK, BGZF_EOF, bgzf, bgzf_block, corpus

CPU = port_mesh(devices=["cpu"])


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh(sp=1)


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()


def _random(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _blocks_300():
    """300 blocks of 1-300 bytes, every 50th one empty."""
    rng = np.random.default_rng(7)
    return [b"" if i % 50 == 49 else corpus(1000 + i, int(rng.integers(1, 300)))
            for i in range(300)]


# name -> (blocks, level)
CASES = {
    "one block": ([corpus(1, 5000)], 6),
    "empty file": ([], 6),
    "an empty block": ([corpus(2, 3000), b"", corpus(3, 2000)], 6),
    "stored blocks": ([corpus(4, 4000), _random(5, 3000)], 0),
    "an incompressible full block": ([corpus(6, 2000),
                                      _random(8, BGZF_BLOCK)], 6),
    "300 blocks": (_blocks_300(), 6),
}


def _answer(payloads, format, **kw):
    """decode_streams_sharded's outputs, an error as (class, message)."""
    outs = PS.decode_streams_sharded(payloads, CPU, format=format,
                                     return_errors=True, **kw)
    return [(type(o).__name__, str(o)) if isinstance(o, Exception) else o
            for o in outs]


def _in_order(payloads, format, monkeypatch):
    """The same call with no BSIZE split: the in-order parse alone."""
    with monkeypatch.context() as m:
        m.setattr(PS, "_bgzf_extents", lambda payload: None)
        return _answer(payloads, format)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("format", ["auto", "bgzf"])
def test_bgzf_decodes_block_by_block(name, format):
    blocks, level = CASES[name]
    payload = bgzf(blocks, level)
    want = b"".join(zlib.decompress(raw_body, -15) for raw_body in
                    (bgzf_block(b, level)[18:-8] for b in blocks))
    assert want == b"".join(blocks)
    outs, stats = PS.decode_streams_sharded([payload], CPU, format=format,
                                            collect_stats=True)
    assert outs == [want]
    assert stats["members"] == stats["bgzf_members"] == len(blocks) + 1
    assert stats["fallbacks"] == 0


@pytest.mark.parametrize("name", ["one block", "an empty block",
                                  "stored blocks"])
def test_bgzf_equals_tbz(mesh, name):
    """tbz reads a BGZF file as multi-member gzip, in order."""
    blocks, level = CASES[name]
    payloads = [bgzf(blocks, level), gzip.compress(corpus(9, 4000))]
    mine = PS.decode_streams_sharded(payloads, CPU)
    assert mine == TS.decode_streams_sharded(payloads, mesh)
    assert mine == [b"".join(blocks), corpus(9, 4000)]


def test_members_are_tokenized_in_the_pool(monkeypatch):
    """One payload's members are tokenized on the pool's threads, more
    than one at a time."""
    blocks = [corpus(30 + i, 2000) for i in range(40)]
    tokenize = PFE.tokenize
    threads, caller = set(), threading.get_ident()

    def spy(*a, **k):
        threads.add(threading.get_ident())
        time.sleep(0.002)
        return tokenize(*a, **k)

    monkeypatch.setattr(PFE, "tokenize", spy)
    assert PS.decode_streams_sharded([bgzf(blocks)], CPU,
                                     format="bgzf") == [b"".join(blocks)]
    assert caller not in threads and len(threads) > 1


def test_the_tokenizer_writes_into_the_arrays_it_is_given():
    """native/loader.tokenize(into=): the tape is views of the arrays
    given; arrays too short for it give way to new ones, with the same
    tape."""
    from tbz_torch.native import loader as PL
    body = zlib.compress(corpus(180, 20000), 6)[2:-4]
    want = PL.tokenize(body).tape
    fields = ("out_len", "dist", "root_val")
    for cap, shared in ((len(body) + 7, True), (16, False)):
        given = tuple(np.full(cap, -1, np.int32) for _ in fields)
        got = PL.tokenize(body, into=given).tape
        assert got.total_out == want.total_out
        for f, arr in zip(fields, given):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert np.shares_memory(getattr(got, f), arr) is shared


def _huffman_only_block(data: bytes) -> bytes:
    """A BGZF member of `data` coded with literals alone (Z_HUFFMAN_ONLY),
    so that its tape holds more tokens than its body holds bytes."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    body = c.compress(data) + c.flush()
    return (bgzf_block(b"")[:16] + (26 + len(body) - 1).to_bytes(2, "little")
            + body + (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
            + len(data).to_bytes(4, "little"))


@pytest.mark.parametrize("format", ["auto", "bgzf"])
def test_members_tokenize_into_one_arena(format):
    """A BGZF payload's tapes are slices of one array (_tape_arena), but a
    member whose tape outgrows its slice (more tokens than body bytes)
    takes arrays of its own; both decode exactly, split by BSIZE."""
    dense = np.random.default_rng(11).choice(
        np.frombuffer(b"ab", np.uint8), BGZF_BLOCK).tobytes()
    blocks = [corpus(190, 9000), dense, corpus(191, 7000)]
    payload = (bgzf_block(blocks[0]) + _huffman_only_block(dense)
               + bgzf_block(blocks[2]) + BGZF_EOF)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        (members,) = PS._front([payload], format, pool, PS._Spans(),
                               tasks=2)
    tapes = [m["res"].tape for m in members]
    assert len(tapes[1]) > len(members[1]["body"])
    arena = tapes[0].out_len.base
    assert arena is not None and arena.shape[0] == 3
    assert tapes[2].dist.base is arena and tapes[1].out_len.base is not arena
    outs, stats = PS.decode_streams_sharded([payload], CPU, format=format,
                                            collect_stats=True)
    assert outs == [b"".join(blocks)]
    assert stats["bgzf_members"] == 4 and stats["fallbacks"] == 0


def test_a_multi_member_gzip_stages_members_at_their_own_width(
        monkeypatch):
    """50 gzip members, not BGZF: each member's staged input row is the
    power of two of its own body, not of the rest of the payload."""
    parts = [corpus(60 + i, 1000 + 97 * i) for i in range(50)]
    members = [gzip.compress(p, 6) for p in parts]
    own = sorted(len(m) - 18 for m in members)   # 10-byte header, trailer
    staged = []
    stage = PS._stage_bucket

    def spy(its, T, M, pool, **kw):
        staged.append((M, [len(mem["body"]) for _, _, mem in its]))
        return stage(its, T, M, pool, **kw)

    monkeypatch.setattr(PS, "_stage_bucket", spy)
    outs, stats = PS.decode_streams_sharded([b"".join(members)], CPU,
                                            collect_stats=True)
    assert outs == [b"".join(parts)]
    assert sorted(n for _, ns in staged for n in ns) == own
    assert all(M == PS._pow2(n, 1024) for M, ns in staged for n in ns)
    assert stats["bgzf_members"] == 0 and stats["members"] == 50
    assert stats["staged_bytes"] >= stats["used_bytes"] > 0


def _lie(payload: bytes, block: int, delta: int) -> bytes:
    """`payload` with the BSIZE of its member `block` moved by `delta`."""
    at = 0
    for _ in range(block):
        at += int.from_bytes(payload[at + 16:at + 18], "little") + 1
    b = int.from_bytes(payload[at + 16:at + 18], "little") + delta
    return payload[:at + 16] + b.to_bytes(2, "little") + payload[at + 18:]


BLOCKS = [corpus(90 + i, 3000) for i in range(3)]
GOOD = bgzf(BLOCKS)
_CRC_AT = len(bgzf_block(BLOCKS[0])) + len(bgzf_block(BLOCKS[1])) - 8
# name -> a payload with one fault
FAULTS = {
    "BSIZE too small": _lie(GOOD, 1, -5),
    "BSIZE too large": _lie(GOOD, 1, +7),
    "BSIZE too large in the last block": _lie(GOOD, 3, +1),
    "a truncated last block": GOOD[:len(GOOD) - len(BGZF_EOF)
                                   - len(bgzf_block(BLOCKS[2])) // 2],
    "a flipped CRC": (GOOD[:_CRC_AT] + bytes([GOOD[_CRC_AT] ^ 1])
                      + GOOD[_CRC_AT + 1:]),
    "a member without BC": (bgzf_block(BLOCKS[0])
                            + gzip.compress(BLOCKS[1], mtime=0) + BGZF_EOF),
    "garbage after the EOF block": GOOD + b"junk",
    "a gzip magic after the EOF block": GOOD + b"\x1f\x8bxx",
}


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("format", ["auto", "bgzf"])
def test_faults_answer_as_the_in_order_parse(name, format, monkeypatch):
    payload = FAULTS[name]
    got = _answer([payload, GOOD], format)
    assert got == _in_order([payload, GOOD], format, monkeypatch)
    assert got[1] == b"".join(BLOCKS)


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_faults_answer_as_tbz(mesh, name):
    payload = FAULTS[name]
    ref = TS.decode_streams_sharded([payload], mesh, return_errors=True)
    ref = [(type(o).__name__, str(o)) if isinstance(o, Exception) else o
           for o in ref]
    assert _answer([payload], "auto") == ref


def test_what_each_fault_gives():
    """Which faults the in-order parse forgives, and the error of each
    other one."""
    got = {name: _answer([p], "bgzf")[0] for name, p in FAULTS.items()}
    data = b"".join(BLOCKS)
    for name in ("BSIZE too small", "BSIZE too large",
                 "BSIZE too large in the last block",
                 "garbage after the EOF block"):
        assert got[name] == data, name
    assert got["a flipped CRC"][0] == "ChecksumError"
    assert got["a truncated last block"][0] == "TruncatedError"
    assert got["a gzip magic after the EOF block"][0] == "TruncatedError"
    assert got["a member without BC"] == (
        "DeflateError", "gzip member without the BGZF BC subfield")
    with pytest.raises(PE.DeflateError) as e:
        PS.decode_streams_sharded([FAULTS["a member without BC"]], CPU,
                                  format="bgzf")
    assert e.value.code == PE.ERR_HEADER
    # not BGZF: "auto" reads it as gzip
    assert _answer([FAULTS["a member without BC"]], "auto")[0] == \
        BLOCKS[0] + BLOCKS[1]


def test_a_fault_sends_its_payload_alone_to_the_in_order_parse():
    payloads = [FAULTS["BSIZE too small"], GOOD, GOOD]
    outs, stats = PS.decode_streams_sharded(payloads, CPU,
                                            collect_stats=True)
    assert outs == [b"".join(BLOCKS)] * 3
    assert stats["fallbacks"] == 1
    assert stats["bgzf_members"] == 2 * (len(BLOCKS) + 1)


def test_launches_are_cut_at_max_rows(monkeypatch):
    """With the limit lowered, a bucket's rows go in several launches,
    and every output is the uncut one."""
    blocks = [corpus(120 + i, 2500) for i in range(7)]
    payloads = [bgzf(blocks), gzip.compress(corpus(130, 2500)),
                bgzf(blocks[:2])]
    whole, whole_stats = PS.decode_streams_sharded(payloads, CPU,
                                                   collect_stats=True)
    monkeypatch.setattr(PS, "MAX_ROWS", 2)
    cut, cut_stats = PS.decode_streams_sharded(payloads, CPU,
                                               collect_stats=True)
    assert cut == whole == [b"".join(blocks), corpus(130, 2500),
                            b"".join(blocks[:2])]
    assert whole_stats["members"] == cut_stats["members"] == 12
    assert cut_stats["launches"] > whole_stats["launches"]
    assert cut_stats["launches"] == sum(
        -(-len(its) // 2) for its in _buckets(payloads))


def _buckets(payloads):
    out: dict = {}
    for p in payloads:
        for mem in PS._tokenize_members(p, "auto"):
            out.setdefault(PS._bucket_key(mem), []).append(mem)
    return list(out.values())


SPANS = tuple(f"batch.{n}" for n in PS._Spans.NAMES)


class Recorder:
    """Stands in for profiling.metrics, as the benchmark's traced runs
    replace it: each stage kept as (name, t0, t1), the rest passed on."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: list = []

    @contextlib.contextmanager
    def stage(self, name, nbytes):
        t0 = time.perf_counter()
        try:
            with self.inner.stage(name, nbytes):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def __getattr__(self, key):
        return getattr(self.inner, key)


@pytest.fixture
def profiled(monkeypatch):
    rec = Recorder(PP.Metrics())
    monkeypatch.setattr(PP, "metrics", rec)
    saved = PC.get_config()
    PC.set_config(dataclasses.replace(saved, profile=True))
    yield rec
    PC.set_config(saved)


def test_batch_spans_nest_in_decode_batch(profiled):
    blocks = [corpus(140 + i, 20000) for i in range(5)]
    payloads = [bgzf(blocks), zlib.compress(corpus(150, 30000))]
    outs = PS.decode_streams_sharded(payloads, CPU)
    assert outs == [b"".join(blocks), corpus(150, 30000)]
    outer = [s for s in profiled.spans if s[0] == "decode.batch"]
    assert len(outer) == 1
    _, a, b = outer[0]
    inner = sorted((s for s in profiled.spans if s[0] != "decode.batch"),
                   key=lambda s: s[1])
    assert {s[0] for s in inner} == set(SPANS)
    assert [s[0] for s in inner[:2]] == ["batch.split", "batch.tokenize"]
    assert inner[-1][0] == "batch.fetch"
    for (name, t0, t1), (_, n0, _) in zip(inner, inner[1:]):
        assert a <= t0 <= t1 <= n0 <= b, name
    covered = sum(t1 - t0 for _, t0, t1 in inner)
    assert covered >= 0.9 * (b - a), (covered, b - a)
    report = PP.metrics.report()
    assert "bgzf_members" in report and "fallbacks" in report
    assert PP.metrics.inner.counters["bgzf_members"] == len(blocks) + 1


def test_collect_stats_reads_the_spans(profiled):
    payloads = [bgzf([corpus(160 + i, 9000) for i in range(3)])]
    outs, stats = PS.decode_streams_sharded(payloads, CPU,
                                            collect_stats=True)
    spans: dict = {}
    for name, t0, t1 in profiled.spans:
        spans[name] = spans.get(name, 0.0) + (t1 - t0) * 1e3
    for n in PS._Spans.NAMES:
        # the recorder's clock reads sit just outside the span's own
        assert 0 < stats[f"{n}_ms"] <= spans[f"batch.{n}"] + 1e-9, n
    assert set(stats) == set(PS._Spans.COUNTS) | {
        f"{n}_ms" for n in PS._Spans.NAMES}


def test_onchip_rows_is_zero_on_a_cpu_mesh(profiled):
    """`onchip_rows`, the rows K7 resolves in one SM's shared memory, is
    a counter of collect_stats and of Config.profile's report; on a CPU
    mesh the plain version resolves every row, so it reads 0 there."""
    blocks = [corpus(175 + i, 7000) for i in range(4)]
    outs, stats = PS.decode_streams_sharded([bgzf(blocks)], CPU,
                                            format="bgzf",
                                            collect_stats=True)
    assert outs == [b"".join(blocks)]
    assert stats["members"] == 5 and stats["launches"] >= 1
    assert stats["onchip_rows"] == 0
    assert "onchip_rows" in PP.metrics.report()
    assert PP.metrics.inner.counters["onchip_rows"] == 0


def test_profiling_off_reads_no_clock_and_calls_no_synchronize(
        monkeypatch):
    clock_reads, syncs, counted = [], [], []
    clock = time.perf_counter

    def spy():
        clock_reads.append(1)
        return clock()

    monkeypatch.setattr(time, "perf_counter", spy)
    monkeypatch.setattr(PP, "_sync", lambda device: syncs.append(device))
    monkeypatch.setattr(PP.metrics, "count", lambda c: counted.append(c))
    payload = bgzf([corpus(170, 5000)])
    assert PS.decode_streams_sharded([payload], CPU) == [corpus(170, 5000)]
    assert clock_reads == [] and syncs == [] and counted == []
