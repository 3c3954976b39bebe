"""tbz_torch's CUDA kernels against their plain PyTorch versions, on the
card. Skips without a CUDA device. Where JAX is not installed, run it
without this directory's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Outputs are integers and bytes: tolerance 0."""

import gzip
import zlib

import numpy as np
import pytest
import torch

from torch_util import (checksum_edge_cases, corpus, mixed_blocks,
                        rowgather_edge_cases, rowgather_rot_accum_cases,
                        rowgather_strided_inputs, short_blocks)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(body: bytes, dev):
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import batched as B
    scan = NL.scan_headers(body)
    plan = B._build_plan(len(body) * 8, scan, 8192)
    return scan, plan, B.plan_from_numpy(plan, dev), B.stage_stream(body, dev)


def test_kernels_match_plain_versions(cuda):
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import fused as F
    from tbz_torch.ops import tokenize_device as TD
    body = mixed_blocks(3)
    scan, plan, dp, data32 = _plan(body, cuda)
    lt, dt, le, de = TD.build_flat_table(dp.lit_pad, dp.dist_pad)
    plt, ple = TD._build_flat_table_plain(dp.lit_pad, TD._consts_on(cuda)[0],
                                          True)
    assert torch.equal(le, ple)
    assert torch.equal(lt[le == 0], plt[le == 0])
    args = (data32, lt, dt, dp.tbl_idx, dp.lane_starts, dp.lane_ends,
            len(body) * 8, plan.S)
    for k, p in zip(B._lanes_multi(*args), B._lanes_multi_plain(*args)):
        assert torch.equal(k, p)
    flat = B._batched_kernel(data32, *dp, len(body) * 8, plan.L, plan.S,
                             plan.B, plan.n_out)
    hdr = plan.hdr_len
    meta = B._parse_meta(flat[:hdr].cpu().numpy(), plan)
    pb = F._PlanBuilder(meta)
    B._walk(body, scan, plan, meta, B._new_stats(), pb.emit_dev,
            pb.emit_host)
    si = F.splice_inputs_from_numpy(pb, b"", cuda)
    compact = flat[hdr:]
    k, kp = F._splice_resolve(compact, data32.view(torch.uint8), si)
    p, pp = F._splice_resolve_plain(compact, data32.view(torch.uint8), si)
    n = 4 + 32768 + pb.n_bytes
    assert int(kp) == pp and torch.equal(k[:n], p[:n])
    assert k[4 + 32768:n].cpu().numpy().tobytes() == \
        zlib.decompress(body, -15)


def test_decompress_default_device_launches_kernels(cuda):
    import tbz_torch
    from tbz_torch import _cuda
    d1, d2 = corpus(1, 300 << 10), corpus(2, 20 << 10)
    payload = gzip.compress(d1) + gzip.compress(d2)
    _cuda.reset_counts()
    assert tbz_torch.decompress(payload) == d1 + d2
    counts = _cuda.launch_counts()
    assert all(counts[k] > 0 for k in (
        "build_flat_table", "lanes_multi", "stitch_compact",
        "splice_resolve", "resolve_core", "resolve_flat"))


def test_checksum_kernels_match_plain_and_zlib(cuda):
    import numpy as np
    from tbz_torch import checksums as cs
    rng = np.random.default_rng(11)
    for n in (0, 1, 5000, 32768, 32769, 200_003):
        host = rng.integers(0, 256, n + 37, dtype=np.uint8)
        dev = torch.from_numpy(host).to(cuda)
        cpu = torch.from_numpy(host)
        head, tail = host[:n].tobytes(), host[37:].tobytes()
        for prev in (0, 0xDEADBEEF):
            got = cs.crc32_device_tail(dev, n, prev)
            assert got == cs.crc32_device_tail(cpu, n, prev) \
                == zlib.crc32(head, prev)
            assert cs.crc32_device(dev, n, prev) == zlib.crc32(tail, prev)
        for prev in (1, 0x1234ABCD & 0xFFF0FFF0):
            got = cs.adler32_device_tail(dev, n, prev)
            assert got == cs.adler32_device_tail(cpu, n, prev) \
                == zlib.adler32(head, prev)
            assert cs.adler32_device(dev, n, prev) == zlib.adler32(tail, prev)
    rows = torch.from_numpy(rng.integers(0, 256, (4, 70000),
                                         dtype=np.uint8)).to(cuda)
    lens = np.array([0, 1, 69999, 40000])
    crcs = cs.crc32_device_tail_batch(rows, lens).cpu()
    adlers = cs.adler32_device_tail_batch(rows, lens).cpu()
    for i, n in enumerate(lens):
        b = rows[i, :n].cpu().numpy().tobytes()
        assert int(crcs[i]) == zlib.crc32(b)
        assert int(adlers[i]) == zlib.adler32(b)
    for len2 in (0, 12345, 2**29 + 5, 2**30 + 7):
        assert cs.crc32_combine_device(0x12345678, 0x9ABCDEF0, len2) == \
            cs.crc32_combine(0x12345678, 0x9ABCDEF0, len2)
        assert cs.adler32_combine_device(0x12345678, 0x9ABCDEF0, len2) == \
            cs.adler32_combine(0x12345678, 0x9ABCDEF0, len2)
    for name, rows, offs, lens, prevs in checksum_edge_cases(cuda):
        got = cs._rows(name, rows, offs, lens, prevs).cpu()
        plain = cs._rows(name, rows.cpu(), offs, lens, prevs)
        z = getattr(zlib, name)
        for i, (o, n, p) in enumerate(zip(offs, lens, prevs)):
            want = z(rows[i, o:o + n].cpu().numpy().tobytes(), p)
            assert int(got[i]) == int(plain[i]) == want, (name, i, o, n)


def test_resolve_batch_matches_plain(cuda):
    import numpy as np
    from tbz_torch import reference as Ref
    from tbz_torch.ops import resolve as R
    datas = [corpus(30 + i, 20000 + 9000 * i) for i in range(3)]
    tapes = [Ref.tokenize_host(zlib.compress(d, 6)[2:-4]).tape
             for d in datas]
    bodies = [zlib.compress(d, 6)[2:-4] for d in datas]
    T = R._pad_pow2(max(len(t) for t in tapes))
    cap = R._pad_pow2(max(t.total_out for t in tapes), floor=4096)
    M = max(len(b) for b in bodies)
    arr = np.zeros((3, 3, T), np.int32)
    inp = np.zeros((3, M), np.uint8)
    for i, (t, b) in enumerate(zip(tapes, bodies)):
        arr[0, i, :len(t)] = t.out_len
        arr[1, i, :len(t)] = t.dist
        arr[2, i, :len(t)] = t.root_val
        inp[i, :len(b)] = np.frombuffer(b, np.uint8)
    nt = np.array([len(t) for t in tapes], np.int32)
    tot = np.array([t.total_out for t in tapes])
    win = np.zeros((3, R.W), np.uint8)

    def run(dev):
        up = [torch.from_numpy(a).to(dev) for a in (*arr, nt)]
        return R._resolve_batch(*up, tot, torch.from_numpy(inp).to(dev),
                                torch.from_numpy(win).to(dev), cap)

    k, kp = run(cuda)
    p, pp = run(torch.device("cpu"))
    assert int(kp) == pp
    for i, d in enumerate(datas):
        assert k[i, :len(d)].cpu().numpy().tobytes() == d
        assert torch.equal(k[i, :len(d)].cpu(), p[i, :len(d)])


def test_device_resident_and_batched_members(cuda):
    import tbz_torch
    from tbz_torch import _cuda
    from tbz_torch.parallel import shard
    d1, d2 = corpus(40, 300 << 10), corpus(41, 20 << 10)
    payload = gzip.compress(d1) + gzip.compress(d2)
    _cuda.reset_counts()
    out = tbz_torch.decompress(payload, device_resident=True)
    assert out.is_cuda and out.cpu().numpy().tobytes() == d1 + d2
    assert _cuda.launch_counts()["crc32"] == 2
    bad = bytearray(payload)
    bad[-6] ^= 0xFF
    with pytest.raises(tbz_torch.DeflateError):
        tbz_torch.decompress(bytes(bad), device_resident=True)
    from tbz_torch.parallel.mesh import make_mesh
    for mesh in (None, make_mesh(devices=["cuda:0"] * 2)):
        outs = shard.decode_streams_sharded(
            [payload, zlib.compress(d2), bytes(bad)], mesh,
            return_errors=True)
        assert outs[:2] == [d1 + d2, d2]
        assert isinstance(outs[2], tbz_torch.DeflateError)
    assert _cuda.launch_counts()["resolve_batch"] > 0


def test_tokenize_device_matches_plain(cuda):
    """csrc/inflate.cu against _tokenize_device_plain: all eight outputs,
    on every block type, bit flips (the error codes), truncations and a
    tape overflow."""
    import random
    from tbz_torch.ops import tokenize_device as TD
    from torch_util import raw_deflate
    data = corpus(50, 24 << 10)
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    bodies = [raw_deflate(data, lv) for lv in (0, 1, 6, 9)]
    bodies.append(co.compress(data) + co.flush())
    rng = random.Random(7)
    for _ in range(12):
        b = bytearray(bodies[3])
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        bodies.append(bytes(b))
    bodies += [bodies[2][:len(bodies[2]) // 3], b"\x07"]
    errs = set()
    for body in bodies:
        for T in (1 << max(10, len(body).bit_length()), 64):
            w = TD.stage_words(body, cuda)
            kt, kr = TD.tokenize_device_impl(w, len(body) * 8, 0, T)
            pt, pr = TD._tokenize_device_plain(w.cpu(), len(body) * 8, 0, T)
            assert torch.equal(kr.cpu(), pr), (len(body), T)
            assert torch.equal(kt.cpu(), pt)
            errs.add(int(pr[3]))
    assert len(errs) > 3
    assert TD.tokenize_device(bodies[2]).tape.total_out == len(data)


def test_resolve_flat_matches_plain(cuda):
    from tbz_torch import reference as Ref
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    from torch_util import raw_deflate
    zd = corpus(51, 20000)
    data = zd[:5000] + corpus(52, 300 << 10) + b"xy" * 4000
    body = raw_deflate(data, 6, zdict=zd)
    tape = NL.tokenize(body, 0, len(zd)).tape
    for G, K, seg_rows in ((4096, 4, 16384), (512, 2, 256)):
        plan = NL.plan_spans_flat(tape, body, window_len=len(zd), G=G, K=K,
                                  seg_rows=seg_rows)
        staged = RS.stage_flat_plan(plan, zd)
        k = RS._resolve_flat_impl(RS.flat_plan_from_numpy(staged, cuda))
        p = RS._resolve_flat_plain(RS.flat_plan_from_numpy(staged, "cpu"))
        n = plan.total_out
        assert torch.equal(k[:n].cpu(), p[:n])
        assert k[:n].cpu().numpy().tobytes() == data
    assert Ref.tokenize_host(body, 0, len(zd)).tape.total_out == len(data)


def test_declined_routes_launch_their_kernels(cuda):
    """Bodies the fused decode declines, through both frontends: under
    64 KB the sequential tokenizer, a static-only stream above it the
    speculative tier; the flat span resolver on every one."""
    import tbz_torch
    from tbz_torch import _cuda
    from tbz_torch.utils import config as C
    from torch_util import raw_deflate
    small = corpus(53, 40 << 10)
    big = corpus(54, 600 << 10)
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    static = co.compress(big) + co.flush()
    assert len(static) >= 1 << 16
    saved = C.get_config()
    try:
        for fe in ("auto", "device"):
            C.set_config(C.Config(frontend=fe))
            _cuda.reset_counts()
            assert tbz_torch.decompress(gzip.compress(small, 6)) == small
            assert tbz_torch.decompress(raw_deflate(small, 0), "raw") == small
            assert tbz_torch.decompress(static, "raw") == big
            counts = _cuda.launch_counts()
            assert counts["resolve_flat"] == 3
            if fe == "device":
                assert counts["tokenize_device"] == 2
                assert counts["build_flat_table"] > 0
                assert counts["lanes_multi"] > 0
            else:
                assert counts["tokenize_device"] == 0
    finally:
        C.set_config(saved)


def test_rowgather_kernels_match_plain(cuda):
    """The four probes (three kernels) against their plain versions, at
    the spike's shapes, at a ragged N with out-of-range indices, and
    against the spike's numpy checks."""
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    _cuda.reset_counts()
    for which in RG.PROBES:
        for n, r in ((8192, 4096), (1001, 17)):
            inp = RG.probe_inputs(which, n, r)
            k = RG.call(which, RG.to_tensors(inp, cuda))
            p = RG.call(which, RG.to_tensors(inp, "cpu"))
            assert torch.equal(k.cpu(), p)
            assert (k.cpu().numpy().view("uint32")
                    == RG.expected(which, inp)).all()
    counts = _cuda.launch_counts()
    assert all(counts[k] == 2 for k in ("copy_rows", "rot_rows",
                                        "accum_rows", "grid_rows"))
    tbl = torch.arange(4 * 32, dtype=torch.int32).reshape(4, 32)
    idx = torch.tensor([1, -1, 4, 3], dtype=torch.int32)
    assert torch.equal(RG.copy_rows(idx.to(cuda), tbl.to(cuda)).cpu(),
                       RG.copy_rows(idx, tbl))
    assert torch.equal(RG.accum_rows(idx.to(cuda), idx.to(cuda),
                                     tbl.to(cuda)).cpu(),
                       RG.accum_rows(idx, idx, tbl))


def test_copy_and_grid_rows_edge_cases(cuda):
    """copy_rows (16-byte loads) and grid_rows (the bulk-copy engine)
    equal _copy_rows_plain on ragged row counts, indices outside the
    table and views 4 bytes into their storage (the 4-byte-load paths),
    at N=8192, R=4096 and N=2^22, R=2^20; a launch counted for each
    call with N > 0, none for N = 0."""
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    cases = rowgather_edge_cases(cuda, ((8192, 4096), (1 << 22, 1 << 20)))
    _cuda.reset_counts()
    for name, idx, tbl in cases:
        want = RG._copy_rows_plain(idx, tbl)
        for fn in (RG.copy_rows, RG.grid_rows):
            got = fn(idx, tbl)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fn.__name__, name)
        del want, got
    counts = _cuda.launch_counts()
    n = sum(1 for _, idx, _ in cases if idx.numel())
    assert counts["copy_rows"] == counts["grid_rows"] == n == len(cases) - 1


def test_rot_and_accum_rows_edge_cases(cuda):
    """rot_rows (copy_rows' loader and a rotation inside each row's 8
    lanes) and accum_rows (the counting sort, each output row written
    once) equal their plain versions exactly on
    torch_util.rowgather_rot_accum_cases at N=8192, R=4096 and N=2^22,
    R=2^20 (ragged N, idx and dst outside, rot over all of int32, views
    4 bytes into their storage, all rows into row 0, a skew, buckets at
    the kernel's tier edges), and so do copy_rows and grid_rows on the
    same idx and tbl; a launch counted for each call with N > 0."""
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    cases = rowgather_rot_accum_cases(cuda, ((8192, 4096), (1 << 22, 1 << 20)))
    _cuda.reset_counts()
    for name, idx, rot, dst, tbl in cases:
        for fn, plain, args in (
                (RG.rot_rows, RG._rot_rows_plain, (idx, rot, tbl)),
                (RG.accum_rows, RG._accum_rows_plain, (idx, dst, tbl)),
                (RG.copy_rows, RG._copy_rows_plain, (idx, tbl)),
                (RG.grid_rows, RG._copy_rows_plain, (idx, tbl))):
            got = fn(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(*args)), (fn.__name__, name)
            del got
    counts = _cuda.launch_counts()
    n = sum(1 for c in cases if c[1].numel())
    assert all(counts[k] == n for k in ("copy_rows", "rot_rows",
                                        "accum_rows", "grid_rows"))


@pytest.mark.parametrize("skew", ["uniform", "all into row 0", "pieces"])
def test_accum_rows_in_rounds(cuda, skew):
    """Past 2^23 output rows (ROUND = FINE_MAX * MAX_NB) accum_rows takes
    a launch a round: equal to its plain version on N = 2^23 + 4097 rows
    (two rounds), dst uniform (1% of idx and dst outside), all into row 0
    (4097 pieces of one bucket), or with buckets past PIECE in both
    rounds (2049, 3000 and 40000 rows)."""
    from tbz_torch.ops import rowgather as RG
    N, R = (1 << 23) + 4097, 4096
    g = torch.Generator(device=cuda).manual_seed(37)
    idx = torch.randint(0, R, (N,), generator=g, device=cuda,
                        dtype=torch.int32)
    dst = torch.randint(0, N, (N,), generator=g, device=cuda,
                        dtype=torch.int32)
    if skew == "uniform":
        idx[torch.rand(N, generator=g, device=cuda) < 0.01] = -1
        dst[torch.rand(N, generator=g, device=cuda) < 0.01] = N
    elif skew == "all into row 0":
        dst.zero_()
    else:
        dst[:2049], dst[2049:5049], dst[5049:45049] = 7, 8, N - 1
    tbl = torch.randint(-2**31, 2**31 - 1, (R, 32), generator=g,
                        device=cuda, dtype=torch.int32)
    got = RG.accum_rows(idx, dst, tbl)
    torch.cuda.synchronize()
    assert torch.equal(got, RG._accum_rows_plain(idx, dst, tbl))


def test_accum_rows_scratch(cuda):
    """The C entry refuses a scratch one int32 short of
    rowgather.accum_scratch_ints (cudaErrorInvalidValue, no launch) and
    takes one of that size."""
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    lib = _cuda.lib()
    idx = torch.arange(2048, dtype=torch.int32, device=cuda)
    tbl = torch.ones(4096, 32, dtype=torch.int32, device=cuda)
    out = tbl.new_empty(2048, 32)
    ws = tbl.new_empty(RG.accum_scratch_ints(2048))
    st = _cuda.stream(out)
    args = (idx.data_ptr(), idx.data_ptr(), 2048, tbl.data_ptr(), 4096,
            out.data_ptr(), ws.data_ptr())
    assert lib.tbz_accum_rows(*args, ws.numel() - 1, st) != 0
    assert lib.tbz_accum_rows(*args, ws.numel(), st) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, RG._accum_rows_plain(idx, idx, tbl))


@pytest.mark.parametrize("n", [8192, 1 << 20])
def test_rowgather_strided_index_vectors(cuda, n):
    """The four probes on index vectors that are strided views (idx[::2],
    rot[::2], dst[::2]): the wrapper's contiguous copies live until the
    launch, so each kernel equals its plain version on the same inputs;
    a launch counted for each."""
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    t = rowgather_strided_inputs(cuda, n, n // 2)
    cpu = {k: v.cpu() for k, v in t.items()}
    _cuda.reset_counts()
    for which in RG.PROBES:
        got = RG.call(which, t)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), RG.call(which, cpu)), which
    counts = _cuda.launch_counts()
    assert all(counts[k] == 1 for k in ("copy_rows", "rot_rows",
                                        "accum_rows", "grid_rows"))


def test_combine_tree_on_the_card(cuda):
    import numpy as np
    from tbz_torch import checksums as cs
    from tbz_torch.parallel import shard
    lens = [2**31 + 5, 3, 2**31 - 1, 0, 2**30 + 7, 12345, 2**32 + 9]
    rng = np.random.default_rng(9)
    for kind, vals in (
            ("crc32", [int(v) for v in rng.integers(0, 2**32, 7)]),
            ("adler32", [int(a) << 16 | int(b) for a, b in
                         rng.integers(0, cs.ADLER_MOD, (7, 2))])):
        got = shard._fold(kind, torch.tensor(vals, device=cuda),
                          torch.tensor(lens, device=cuda))
        want = shard._fold(kind, torch.tensor(vals), torch.tensor(lens))
        assert int(got) == int(want)


def test_sharded_checksums_on_one_card_four_times(cuda):
    import numpy as np
    from tbz_torch.parallel import shard
    from tbz_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=["cuda:0"] * 4)
    N = 4 * 4096 * 16
    data = np.random.default_rng(5).integers(0, 256, N, dtype=np.uint8)
    buf = torch.from_numpy(data).to(cuda)
    crc = shard.make_sharded_crc32(mesh, N)
    adler = shard.make_sharded_adler32(mesh, N)
    for n in (N, N - 777, 5000, 0):
        b = data[:n].tobytes()
        assert crc(buf, n) == crc(data, n) == zlib.crc32(b)
        assert adler(buf, n) == adler(data, n) == zlib.adler32(b)


def test_flat_baseline_layouts_on_the_card(cuda):
    """tbz's scan and gscat layouts of the flat resolve run spans.cu and
    give _resolve_flat_impl's rows."""
    import numpy as np
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    from torch_util import raw_deflate
    data = corpus(55, 200 << 10)
    body = raw_deflate(data, 6)
    plan = NL.plan_spans_flat(NL.tokenize(body).tape, body, G=512, K=2,
                              seg_rows=256)
    st = RS.stage_flat_plan(plan)
    ref = RS._resolve_flat_impl(RS.flat_plan_from_numpy(st, cuda))
    bs = np.asarray(plan.b_segrow, np.int32)
    out0 = st[6].view("<u4").reshape(-1, 32)
    wrows = st[7].view("<u4").reshape(RS.W_ROWS, 32)
    scan = RS._resolve_flat_scan_impl(st[0], st[1], st[2], bs, out0, wrows,
                                      out0.shape[0], plan.seg_rows)
    gscat = RS._resolve_flat_gscat_impl(st[0], st[1], st[2] + bs[:, None],
                                        out0, wrows, out0.shape[0])
    assert scan.is_cuda and torch.equal(scan, ref) and torch.equal(gscat, ref)
    assert ref[:len(data)].cpu().numpy().tobytes() == data


def _stitch_equal(args):
    """Kernel 3 against its plain version on one input: the metadata
    header and compact[:total] equal."""
    from tbz_torch.ops import batched as B
    L, Bp = args[7], args[9]
    k = B._stitch_compact(*args[:10], args[10].clone())
    p = B._stitch_compact_plain(*args[:10], args[10].clone())
    hdr = 7 * L + 2 * Bp + 1
    total = int(p[hdr - 1])
    assert torch.equal(k[:hdr], p[:hdr])
    assert torch.equal(k[hdr:hdr + total], p[hdr:hdr + total])
    return p[2 * L:3 * L].cpu()


def _lane_tape(body: bytes, dev):
    """Kernels 1-2 on the card: kernel 3's arguments for `body`'s plan."""
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import tokenize_device as TD
    _, plan, dp, data32 = _plan(body, dev)
    L, Bp = plan.L, plan.B
    flat = torch.zeros(plan.hdr_len + plan.n_out + 1, dtype=torch.int32,
                       device=dev)
    lt, dt, _, _ = TD.build_flat_table(dp.lit_pad, dp.dist_pad,
                                       flat[7 * L:7 * L + Bp],
                                       flat[7 * L + Bp:7 * L + 2 * Bp])
    starts, packed, dist, _, ok = B._lanes_multi(
        data32, lt, dt, dp.tbl_idx, dp.lane_starts, dp.lane_ends,
        len(body) * 8, plan.S, exits=flat[4 * L:5 * L])
    return [starts, packed, dist, ok, dp.tbl_idx, dp.seg_id, dp.seg_sym,
            L, plan.S, Bp, flat]


@pytest.mark.parametrize("ext_bits", [384, 8])
def test_stitch_matches_plain_on_short_blocks(cuda, monkeypatch, ext_bits):
    """Streams of many short dynamic blocks (flushes every 200-3000
    bytes), and the same with forced junctions (EXT_BITS = 8)."""
    from tbz_torch.ops import batched as B
    monkeypatch.setattr(B, "EXT_BITS", ext_bits)
    flags = [_stitch_equal(_lane_tape(short_blocks(seed, 200 << 10), cuda))
             for seed in (1, 2)]
    flags = torch.cat(flags)
    assert bool((flags & B.F_SKIP).any())
    if ext_bits == 8:
        assert bool((flags & B.F_DEAD).any())


def test_stitch_matches_plain_on_hand_built_tapes(cuda):
    """The merge-point mask case (lane 2's first hit lies below lane 1's
    merge point) and seeded synthetic tapes with overlaps, gaps, short
    lanes, end-of-block codes and failed lanes."""
    from tbz_torch.ops import batched as B
    from torch_util import stitch_flat, stitch_mask_tape, stitch_random_tape
    args = stitch_flat(stitch_mask_tape(), cuda)
    _stitch_equal(args)
    k = B._stitch_compact(*args[:10], args[10].clone())
    assert k[:3].tolist() == [0, 2, 2]     # merge positions
    for seed in range(12):
        _stitch_equal(stitch_flat(stitch_random_tape(seed), cuda, seed))


def test_tokenize_device_edge_cases(cuda):
    """Past one staging chunk: stored blocks that cross chunk boundaries
    and a long dynamic body; a tape shorter than the tokens; a bad
    code-length repeat."""
    from tbz_torch.ops import tokenize_device as TD
    from torch_util import bad_cl_repeat_header, raw_deflate
    data = corpus(56, 200 << 10)
    cases = [(raw_deflate(data, 0), None), (raw_deflate(data, 6), None),
             (raw_deflate(data, 6), 1000), (short_blocks(5, 60 << 10), None),
             (bad_cl_repeat_header(), None)]
    errs = []
    for body, T in cases:
        T = T or 1 << max(10, (8 * len(body) + 16).bit_length())
        w = TD.stage_words(body, cuda)
        kt, kr = TD.tokenize_device_impl(w, len(body) * 8, 0, T)
        pt, pr = TD._tokenize_device_plain(w.cpu(), len(body) * 8, 0, T)
        assert torch.equal(kr.cpu(), pr) and torch.equal(kt.cpu(), pt)
        errs.append(int(pr[3]))
    assert errs == [0, 0, 11, 0, 7]


def _root_exact(tabs):
    """Every entry of 10 bits or less in a table's first 1024 slots
    repeats at all 32 of its aliases (what csrc/lanes.cu's root needs)."""
    root = tabs[:, :1024]
    short = (root & 0xF) <= 10
    same = tabs.view(-1, 32, 1024) == root[:, None, :]
    return bool((same | ~short[:, None, :]).all())


@pytest.mark.parametrize("seed", [1, 2])
def test_tables_match_plain_on_adversarial_codes(cuda, seed):
    """Kernel 1 on long codes, a single 1-bit code, over-subscribed and
    incomplete sets, padding and the fixed code: err everywhere, the
    tables where err == 0 and where the code is incomplete (row 4)."""
    from tbz_torch.ops import tokenize_device as TD
    from torch_util import adversarial_tables
    lit, dist = (torch.from_numpy(a).to(cuda)
                 for a in adversarial_tables(seed))
    lt, dt, le, de = TD.build_flat_table(lit, dist)
    lc, dc = TD._consts_on(cuda)
    for k, e, (p, pe) in ((lt, le, TD._build_flat_table_plain(lit, lc, True)),
                          (dt, de, TD._build_flat_table_plain(dist, dc,
                                                              True))):
        assert torch.equal(e, pe) and e.tolist() == [0, 0, 0, 4, 4, 0, 0, 0]
        assert torch.equal(k[e == 0], p[e == 0])
        assert torch.equal(k[4], p[4])
        assert _root_exact(k)


@pytest.mark.parametrize("case", range(5))
def test_lanes_match_plain_on_adversarial_inputs(cuda, case):
    """Kernel 2 against its plain version on kernel 1's tables: codes of
    11-15 bits (root misses), err tables, a shuffled tbl_idx, lanes at
    or past total_bits, an odd L, the speculative shape."""
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import tokenize_device as TD
    from torch_util import LANE_CASES, lane_case, root_misses
    (lit, dist), (d32, tbl, st, en, tb, S) = lane_case(LANE_CASES[case],
                                                      cuda)
    lt, dt, _, _ = TD.build_flat_table(lit, dist)
    args = (d32, lt, dt, tbl, st, en, tb, S)
    k = B._lanes_multi(*args)
    for a, b in zip(k, B._lanes_multi_plain(*args)):
        assert torch.equal(a, b)
    lookups, misses = root_misses(d32, lt, dt, tbl, k[0], k[1])
    assert lookups > 0 and (misses > 0 or st.shape[0] == 1)


def test_auto_backend_on_a_card(cuda):
    """backend="auto" is the native host inflate on a machine with a
    card too: tbz's bytes, and no kernel launched."""
    import tbz_torch
    from tbz_torch import _cuda
    data = corpus(57, 300 << 10)
    payload = gzip.compress(data, 6)
    _cuda.reset_counts()
    assert tbz_torch.decompress(payload, backend="auto") == data
    assert not any(_cuda.launch_counts().values())


@pytest.mark.parametrize("kind", ["deep", "far", "stored"])
def test_resolve_core_matches_plain_on_adversarial_tapes(cuda, kind):
    """Kernel 4's core (resolve_core) and the splice + resolve kernel
    (every token a host token) against their plain versions on 1 MiB
    tapes: a distance-1 run ~20 passes deep, chains at distance 32768
    into a preset window, stored runs between matches. Whole buffers and
    pass counts equal; each counter moved."""
    from tbz_torch import _cuda
    from tbz_torch.ops import fused as F
    from tbz_torch.ops import resolve as R
    from torch_util import host_splice, resolve_case
    tape, inp, win, want = resolve_case(kind, 1)
    _cuda.reset_counts()
    k, total, kp = R.resolve_device(tape, inp, win, device=cuda,
                                    collect_stats=True)
    p, _, pp = R.resolve_device(tape, inp, win, device="cpu",
                                collect_stats=True)
    assert kp == pp and torch.equal(k.cpu(), p)
    assert k[R.W:R.W + total].cpu().numpy().tobytes() == want
    u8 = torch.from_numpy(np.frombuffer(inp or b"\0", np.uint8).copy())
    compact = torch.zeros(1, dtype=torch.int32)
    pb = host_splice(tape, win)
    ks, ksp = F._splice_resolve(compact.to(cuda), u8.to(cuda),
                                F.splice_inputs_from_numpy(pb, win, cuda))
    ps, psp = F._splice_resolve_plain(compact, u8,
                                      F.splice_inputs_from_numpy(pb, win,
                                                                 "cpu"))
    assert int(ksp) == psp == pp and torch.equal(ks.cpu(), ps)
    counts = _cuda.launch_counts()
    assert counts["resolve_core"] == 2 and counts["splice_resolve"] == 1


def test_resolve_batch_matches_plain_on_adversarial_rows(cuda):
    """Kernel 7 on rows of very different depths: a deep run, an empty
    row, a far-chain row with a window that fills the capacity, a stored
    row and 100 literals. Rows and the batch's pass count equal."""
    from tbz_torch import _cuda
    from tbz_torch.ops import resolve as R
    from torch_util import resolve_batch_case, stage_resolve_batch
    rows, cap = resolve_batch_case(7)
    ol, di, rv, nt, tot, inp, win, cap = stage_resolve_batch(rows, cap)

    def run(dev):
        up = [torch.from_numpy(a).to(dev) for a in (ol, di, rv, nt)]
        return R._resolve_batch(*up, tot, torch.from_numpy(inp).to(dev),
                                torch.from_numpy(win).to(dev), cap)

    _cuda.reset_counts()
    k, kp = run(cuda)
    p, pp = run(torch.device("cpu"))
    assert _cuda.launch_counts()["resolve_batch"] == 1
    assert int(kp) == pp and torch.equal(k.cpu(), p)
    for r, (_, _, _, want) in enumerate(rows):
        assert k[r, :len(want)].cpu().numpy().tobytes() == want


@pytest.mark.parametrize("case", range(6))
def test_resolve_flat_matches_plain_on_more_plans(cuda, case):
    """spans.cu on the deep-overlap data at three G / K / seg_rows shapes
    and on the three adversarial tapes' plans: equal to the plain
    version over the whole output, and to the tape's bytes."""
    from tbz_torch import _cuda
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    from torch_util import flat_plan_cases
    _, tape, inp, win, want, G, K, seg_rows = flat_plan_cases()[case]
    plan = NL.plan_spans_flat(tape, inp, window_len=len(win), G=G, K=K,
                              seg_rows=seg_rows)
    staged = RS.stage_flat_plan(plan, win)
    _cuda.reset_counts()
    k = RS._resolve_flat_impl(RS.flat_plan_from_numpy(staged, cuda))
    p = RS._resolve_flat_plain(RS.flat_plan_from_numpy(staged, "cpu"))
    assert _cuda.launch_counts()["resolve_flat"] == 1
    assert torch.equal(k.cpu(), p)
    assert k[:plan.total_out].cpu().numpy().tobytes() == want


FUSED = ("build_flat_table", "lanes_multi", "stitch_compact",
         "splice_resolve", "resolve_core")


def test_public_surface_on_a_card(cuda, tmp_path):
    """compress -> decompress at 1 MiB, decompress_file and ZipReader.read
    on the card: zlib's bytes, and the fused decode's kernels launched
    (each counter rises)."""
    import io
    import zipfile
    import tbz_torch
    from tbz_torch import _cuda
    data = corpus(91, 1 << 20)
    for fmt in ("raw", "zlib", "gzip"):
        payload = tbz_torch.compress(data, fmt, 6)
        wbits = {"raw": -15, "zlib": 15, "gzip": 31}[fmt]
        assert zlib.decompressobj(wbits).decompress(payload) == data
        _cuda.reset_counts()
        assert tbz_torch.decompress(payload, fmt) == data
        counts = _cuda.launch_counts()
        assert all(counts[k] > 0 for k in FUSED), (fmt, counts)
    p = tmp_path / "f.gz"
    p.write_bytes(gzip.compress(data, 6))
    for kw in ({}, {"device_resident": True}):
        _cuda.reset_counts()
        out = tbz_torch.decompress_file(p, **kw)
        if kw:
            assert out.is_cuda
            out = out.cpu().numpy().tobytes()
        assert out == data
        counts = _cuda.launch_counts()
        assert all(counts[k] > 0 for k in FUSED), counts
        assert (counts["crc32"] > 0) == bool(kw)
    w = tbz_torch.ZipWriter()
    w.write("big", data)
    w.write("small", data[:5000])
    blob = w.getvalue()
    zf = zipfile.ZipFile(io.BytesIO(blob))
    r = tbz_torch.ZipReader(blob)
    _cuda.reset_counts()
    assert r.read("big") == zf.read("big") == data
    counts = _cuda.launch_counts()
    assert all(counts[k] > 0 for k in FUSED), counts
    _cuda.reset_counts()
    assert r.read("small") == zf.read("small")
    assert _cuda.launch_counts()["resolve_flat"] > 0
    assert r.read_all() == tbz_torch.ZipReader(
        blob, backend="host").read_all() == {"big": data,
                                             "small": data[:5000]}
