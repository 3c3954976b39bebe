"""The row-gather probes: tbz_torch.ops.rowgather's plain versions
against the four Pallas kernels of scripts/pallas_spike_r3.py, run in
interpret mode on the CPU with the spike's grid specs at N=64, R=32, and
against the spike's own numpy checks. Integers: tolerance 0."""

import importlib.util
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tbz_torch.ops import rowgather as RG

import torch_util as TU

SPIKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "pallas_spike_r3.py")
N, R = 64, 32


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def spike():
    """The spike module, loaded without running it: its argv and its
    `bench` import are stood in for, and both restored."""
    saved_argv, saved_bench = sys.argv, sys.modules.get("bench")
    sys.argv = [SPIKE, "copy", str(N), str(R)]
    sys.modules["bench"] = types.SimpleNamespace(
        _enable_compile_cache=lambda jax: None)
    try:
        spec = importlib.util.spec_from_file_location("pallas_spike_r3",
                                                      SPIKE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved_argv
        if saved_bench is None:
            sys.modules.pop("bench", None)
        else:
            sys.modules["bench"] = saved_bench
    return mod


def _vmem_call(kernel, n_prefetch, *args):
    """pallas_call with the spike's grid spec of run_copy / run_rot /
    run_accum (the whole table in VMEM, one grid step), interpreted."""
    return np.asarray(pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=n_prefetch, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((args[0].shape[0], 32), jnp.uint32),
        interpret=True)(*args))


def _port(which, inp):
    return RG.call(which, RG.to_tensors(inp, "cpu")).numpy().view(np.uint32)


def test_copy_kernel(spike):
    inp = RG.probe_inputs("copy", N, R)
    idx, tbl = inp["idx"], inp["tbl"]
    out = _vmem_call(spike._copy_kernel, 1, idx, tbl)
    assert (out == tbl[idx]).all()                  # the spike's check
    assert np.array_equal(_port("copy", inp), out)


def test_rot_kernel(spike):
    inp = RG.probe_inputs("rot", N, R)
    idx, rot, tbl = inp["idx"], inp["rot"], inp["tbl"]
    out = _vmem_call(spike._rot_kernel, 2, idx, rot, tbl)
    want = np.stack([np.roll(tbl[idx[i]], -rot[i]) for i in range(N)])
    assert (out == want).all()                      # the spike's check
    assert np.array_equal(_port("rot", inp), out)
    assert np.array_equal(RG.expected("rot", inp), want)


def test_rot_over_all_32_rotations(spike):
    rng = np.random.default_rng(3)
    inp = dict(idx=rng.integers(0, R, N).astype(np.int32),
               rot=(np.arange(N) % 32).astype(np.int32),
               tbl=rng.integers(0, 2**32, (R, 32), dtype=np.uint32))
    out = _vmem_call(spike._rot_kernel, 2, inp["idx"], inp["rot"],
                     inp["tbl"])
    assert np.array_equal(_port("rot", inp), out)
    for r in range(32):
        rows = inp["rot"] == r
        assert np.array_equal(out[rows],
                              np.roll(inp["tbl"][inp["idx"][rows]], -r, 1))


def _spike_accum_want(inp):
    """The spike's check (lines 155-160): np.add.at in uint64, mod 2^32."""
    want = np.zeros((len(inp["idx"]), 32), np.uint64)
    np.add.at(want, inp["dst"], inp["tbl"][inp["idx"]].astype(np.uint64))
    return (want & 0xFFFFFFFF).astype(np.uint32)


def test_accum_kernel(spike):
    inp = RG.probe_inputs("accum", N, R)
    assert len(np.unique(inp["dst"])) < N          # duplicate destinations
    out = _vmem_call(spike._accum_kernel, 2, inp["idx"], inp["dst"],
                     inp["tbl"])
    want = _spike_accum_want(inp)
    assert (out == want).all()                      # the spike's "OK"
    assert np.array_equal(_port("accum", inp), out)
    assert np.array_equal(RG.expected("accum", inp), want)


def test_accum_duplicates_wrap_mod_2_32(spike):
    """Every row added into 3 destinations, with words near 2^32: the
    sums wrap, and all three agree."""
    rng = np.random.default_rng(4)
    inp = dict(idx=rng.integers(0, R, N).astype(np.int32),
               dst=(np.arange(N) % 3).astype(np.int32),
               tbl=rng.integers(2**32 - 2**20, 2**32, (R, 32),
                                dtype=np.uint32))
    out = _vmem_call(spike._accum_kernel, 2, inp["idx"], inp["dst"],
                     inp["tbl"])
    assert np.array_equal(out, _spike_accum_want(inp))
    assert np.array_equal(_port("accum", inp), out)
    assert not out[3:].any()


def _grid_kern(idx_ref, row_ref, out_ref):
    """run_grid's `kern`, a nested function of the spike, restated."""
    out_ref[...] = row_ref[...]


def _grid_call(idx, tbl):
    """run_grid's pallas_call, interpreted: one (1, 32) block a grid step,
    the row chosen by the scalar-prefetched index."""
    n = idx.shape[0]
    return np.asarray(pl.pallas_call(
        _grid_kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(n,),
            in_specs=[pl.BlockSpec((1, 32),
                                   lambda i, idx_ref: (idx_ref[i], 0))],
            out_specs=pl.BlockSpec((1, 32), lambda i, idx_ref: (i, 0))),
        out_shape=jax.ShapeDtypeStruct((n, 32), jnp.uint32),
        interpret=True)(idx, tbl))


def test_grid_gather():
    """run_grid's `kern` with its grid spec against the port."""
    inp = RG.probe_inputs("grid", N, R)
    idx, tbl = inp["idx"], inp["tbl"]
    out = _grid_call(idx, tbl)
    assert (out == tbl[idx]).all()                  # the spike's check
    assert np.array_equal(_port("grid", inp), out)
    assert np.array_equal(_port("grid", inp), _port("copy", inp))


@pytest.mark.parametrize("n", [0, 1, 3, 5, 33, 257])
def test_copy_and_grid_tails(spike, n):
    """Row counts that are no multiple of a warp step's 4 rows or of a
    32-row tile: copy_rows and grid_rows against _copy_kernel and
    run_grid's `kern` (the spike's prefetch cannot take N = 0: there
    its numpy check, tbl[idx], stands in). Tolerance 0."""
    inp = RG.probe_inputs("copy", n, 37)
    idx, tbl = inp["idx"], inp["tbl"]
    if n:
        want = _vmem_call(spike._copy_kernel, 1, idx, tbl)
        assert np.array_equal(_grid_call(idx, tbl), want)
    else:
        want = tbl[idx]
    assert want.shape == (n, 32)
    assert np.array_equal(_port("copy", inp), want)
    assert np.array_equal(_port("grid", inp), want)


def _rows_numpy(idx, tbl):
    """out[i] = tbl[idx[i]], a zero row where idx[i] is outside the
    table: numpy, apart from the port's plain version."""
    i, t = idx.numpy().astype(np.int64), tbl.numpy()
    ok = (i >= 0) & (i < len(t))
    return np.where(ok[:, None], t[np.where(ok, i, 0)], 0)


@pytest.mark.parametrize("fn", [RG.copy_rows, RG.grid_rows],
                         ids=["copy", "grid"])
def test_indices_outside_the_table_give_zero_rows(fn):
    tbl = torch.arange(5 * 32, dtype=torch.int32).reshape(5, 32) - 77
    idx = torch.tensor([-1, 5, 2**31 - 1, 4, -2**31, 0], dtype=torch.int32)
    out = fn(idx, tbl)
    assert torch.equal(out[3], tbl[4]) and torch.equal(out[5], tbl[0])
    assert not out[[0, 1, 2, 4]].any()
    assert np.array_equal(out.numpy(), _rows_numpy(idx, tbl))


@pytest.mark.parametrize("fn", [RG.copy_rows, RG.grid_rows],
                         ids=["copy", "grid"])
def test_views_at_4_byte_offsets(fn):
    """idx[1:] and a table that starts 4 bytes into its storage are
    legal inputs and give the rows numpy gathers from them."""
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.integers(-2**31, 2**31, 40 * 32 + 1,
                                         dtype=np.int64).astype(np.int32))
    tbl = flat[1:].view(-1, 32)
    idx = torch.from_numpy(rng.integers(-3, 43, 71).astype(np.int32))[1:]
    assert tbl.data_ptr() % 16 == 4 and idx.data_ptr() % 16 == 4
    assert np.array_equal(fn(idx, tbl).numpy(), _rows_numpy(idx, tbl))


@pytest.mark.parametrize("which", RG.PROBES)
def test_strided_index_vectors(which):
    """Index vectors that are strided views (idx[::2], rot[::2],
    dst[::2]) give the rows of their contiguous copies."""
    t = TU.rowgather_strided_inputs("cpu", 300, 37)
    assert not t["idx"].is_contiguous()
    want = RG.call(which, {k: v.clone() for k, v in t.items()})
    assert torch.equal(RG.call(which, t), want)
    if which in ("copy", "grid"):
        assert np.array_equal(want.numpy(), _rows_numpy(t["idx"], t["tbl"]))


@pytest.mark.parametrize("kind", ["copy", "grid"])
@pytest.mark.parametrize("grid", [1, 2, 3, 7])
def test_split_model_covers_every_row_once(kind, grid):
    """csrc/rowgather.cu's row split, modelled on the CPU: every row is
    stored exactly once, for N up to several rings of every block."""
    ring = TU.GRID_STAGES * TU.GRID_ROWS
    for n in sorted({0, 1, 3, 31, 33, 4 * TU.COPY_U + 1, ring - 1, ring,
                     ring + 1, 3 * grid * ring + 5,
                     TU.COPY_THREADS // 8 * TU.COPY_U * grid + 7}):
        rows = [r for r, _ in TU._split_model(kind, n, grid)]
        assert sorted(rows) == list(range(n)), (kind, grid, n)


def test_split_model_constants_are_the_kernels():
    src = open(os.path.join(os.path.dirname(SPIKE), os.pardir, "tbz_torch",
                            "csrc", "rowgather.cu")).read()
    for name in ("COPY_THREADS", "COPY_U", "GRID_ROWS", "GRID_STAGES",
                 "STORE_LAG", "FINE_MAX", "PIECE", "MAX_NB"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(TU, name), name
    # the wrapper's scratch size is the C entry's (which checks it)
    assert "int64_t accum_scratch_ints(int64_t N) { return 2 * N + META; }" \
        in src
    assert "constexpr int META = 3 * (MAX_NB + 1) + 1;" in src
    for n in (1, 1023, 1024, 8192, 1 << 22):
        assert RG.accum_scratch_ints(n) == 2 * n + 3 * (TU.MAX_NB + 1) + 1


@pytest.mark.parametrize("which", RG.PROBES)
def test_probe_entry_on_cpu(which):
    """The CLI's probe (seeded inputs, numpy check, timing) on the CPU,
    at the spike's N and R and at a ragged N."""
    for n, r in ((64, 32), (1000, 7)):
        res = RG.probe(which, n, r, device="cpu", reps=1)
        assert res["ms"] > 0 and res["Mrows_s"] > 0


def test_out_of_range_rows_are_zero():
    tbl = torch.arange(4 * 32, dtype=torch.int32).reshape(4, 32)
    idx = torch.tensor([1, -1, 4, 3], dtype=torch.int32)
    out = RG.copy_rows(idx, tbl)
    assert torch.equal(out[0], tbl[1]) and torch.equal(out[3], tbl[3])
    assert not out[1:3].any()
    dst = torch.tensor([0, 0, 0, 9], dtype=torch.int32)
    acc = RG.accum_rows(torch.tensor([1, 2, -5, 0], dtype=torch.int32),
                        dst, tbl)
    assert torch.equal(acc[0], tbl[1] + tbl[2]) and not acc[1:].any()


def test_wrappers_check_their_inputs():
    tbl = torch.zeros(4, 32, dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        RG.copy_rows(idx.long(), tbl)
    with pytest.raises(ValueError):
        RG.grid_rows(idx, torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        RG.rot_rows(idx, torch.zeros(2, dtype=torch.int32), tbl)
    with pytest.raises(ValueError):
        RG.accum_rows(idx, idx, tbl.float())
    with pytest.raises(ValueError):
        RG.probe_inputs("scatter", 8, 4)


def _rot_numpy(idx, rot, tbl):
    """rot_rows' oracle: each gathered row np.roll'ed left by rot mod 32
    (numpy's mod: a negative rot turns right)."""
    rows, s = _rows_numpy(idx, tbl), rot.numpy().astype(np.int64) % 32
    out = np.zeros_like(rows)
    for k in np.unique(s):
        out[s == k] = np.roll(rows[s == k], -k, axis=1)
    return out


def _accum_numpy(idx, dst, tbl):
    """accum_rows' oracle: np.add.at in uint64 over the rows whose idx
    and dst are in range, mod 2^32, as int32."""
    i, d = idx.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    t = tbl.numpy().view(np.uint32).astype(np.uint64)
    ok = (i >= 0) & (i < len(t)) & (d >= 0) & (d < len(i))
    want = np.zeros((len(i), 32), np.uint64)
    np.add.at(want, d[ok], t[i[ok]])
    return (want & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


ROT_ACCUM = TU.rowgather_rot_accum_cases()
ROT_ACCUM_NAMES = [c[0] for c in ROT_ACCUM]


@pytest.mark.parametrize("name", ROT_ACCUM_NAMES)
def test_rot_rows_edge_cases_equal_np_roll(name):
    """rot_rows on the edge cases (ragged N, indices outside the table,
    rot over all of int32 and its special values, views 4 bytes into
    their storage, skewed dst): its plain version equals np.roll of the
    gathered rows. Tolerance 0."""
    _, idx, rot, _, tbl = ROT_ACCUM[ROT_ACCUM_NAMES.index(name)]
    assert np.array_equal(RG.rot_rows(idx, rot, tbl).numpy(),
                          _rot_numpy(idx, rot, tbl))


@pytest.mark.parametrize("name", ROT_ACCUM_NAMES)
def test_accum_rows_edge_cases_equal_np_add_at(name):
    """accum_rows on the same edge cases (dst outside the output, all
    rows into row 0, buckets at the kernel's tier edges, sums that wrap
    mod 2^32): its plain version equals np.add.at. Tolerance 0."""
    _, idx, _, dst, tbl = ROT_ACCUM[ROT_ACCUM_NAMES.index(name)]
    assert np.array_equal(RG.accum_rows(idx, dst, tbl).numpy(),
                          _accum_numpy(idx, dst, tbl))


def test_rot_accum_cases_cover_their_edges():
    """The edge cases hold what they are for: every special rot, every
    outside idx and dst, 4-byte views, all rows into row 0, and buckets
    on both sides of a 32-entry chunk, of FINE_MAX and of PIECE."""
    rots = set(np.concatenate([c[2].numpy() for c in ROT_ACCUM]).tolist())
    assert set(TU.ROT_SPECIALS) <= rots
    for name, idx, _, dst, tbl in ROT_ACCUM:
        if name == "outside":
            assert {-1, len(tbl), 2**31 - 1, -2**31} <= set(idx.tolist())
            assert {-1, len(dst), 2**31 - 1, -2**31} <= set(dst.tolist())
        if name.endswith("vecs+4B tbl+4B"):
            assert idx.data_ptr() % 16 == 4 and tbl.data_ptr() % 16 == 4
        if name.endswith("all into row 0"):
            assert not dst.any()
        if name.endswith("bucket edges"):
            sizes = np.bincount(dst.numpy())[:7].tolist()
            assert sizes == [31, 32, 33, TU.FINE_MAX, TU.FINE_MAX + 1,
                             1057, TU.PIECE + 52]


@pytest.mark.parametrize("s", range(32))
def test_rotate_model_is_np_roll(s):
    """rot_rows' group rotation (two width-8 shuffles and a select by
    s & 3), replayed on numpy words, equals np.roll by -s."""
    words = np.random.default_rng(s).integers(0, 2**32, 32, dtype=np.uint32)
    assert np.array_equal(TU._rotate_model(words, s), np.roll(words, -s))


@pytest.mark.parametrize("name", ["N=1", "N=257", "N=1001", "outside",
                                  "N=8192 R=4096 all into row 0",
                                  "N=8192 R=4096 skewed",
                                  "N=8192 R=4096 bucket edges"])
@pytest.mark.parametrize("grid", [1, 3, 64])
def test_accum_model_places_every_row_once(name, grid):
    """accum_rows replayed on the CPU (one round: N <= 2^23): the coarse
    counts, their scan and each block's claimed runs place every valid
    row exactly once, inside its coarse bucket; every output row is
    stored exactly once (a bucket's first piece); a later piece adds only
    to rows it holds, all of a bucket's rows past PIECE; and the sum
    equals np.add.at."""
    _, idx, _, dst, tbl = ROT_ACCUM[ROT_ACCUM_NAMES.index(name)]
    i, d = idx.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    N = len(i)
    m = TU._accum_model(i, d, tbl.numpy(), min(grid, N))
    ok = (i >= 0) & (i < len(tbl)) & (d >= 0) & (d < N)
    (r,) = m["rounds"]
    placed = r["ent"][r["ent"] >= 0]
    assert sorted(placed.tolist()) == np.flatnonzero(ok).tolist()
    assert (r["ent"][len(placed):] == -1).all()
    for c in range(len(r["starts"]) - 1):
        rows = r["ent"][r["starts"][c]:r["starts"][c + 1]]
        assert (d[rows] >> r["fb"] == c).all()
    assert sorted(m["stores"]) == list(range(N))
    if name.endswith("all into row 0"):
        assert m["adds"] == {0: -(-int(ok.sum()) // TU.PIECE) - 1}
    assert np.array_equal(m["out"].view(np.int32), _accum_numpy(idx, dst, tbl))


@pytest.mark.parametrize("name", ["N=1001", "outside",
                                  "N=8192 R=4096 all into row 0",
                                  "N=8192 R=4096 skewed",
                                  "N=8192 R=4096 bucket edges"])
@pytest.mark.parametrize("round_rows", [1, 37, 1000, 4096])
def test_accum_model_in_rounds(name, round_rows):
    """accum_rows' rounds (a launch for each ROUND output rows, here
    shrunk to `round_rows`), replayed on the CPU: each round places only
    the valid rows whose dst it covers, each once; together the rounds
    store every output row once, and the sum equals np.add.at."""
    _, idx, _, dst, tbl = ROT_ACCUM[ROT_ACCUM_NAMES.index(name)]
    i, d = idx.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    N = len(i)
    if N > 100 * round_rows:   # N = 8192 in 8192 rounds: left to N = 1001
        round_rows *= 64
    m = TU._accum_model(i, d, tbl.numpy(), min(3, N), round_rows)
    ok = (i >= 0) & (i < len(tbl)) & (d >= 0) & (d < N)
    assert len(m["rounds"]) == -(-N // round_rows)
    placed = []
    for r in m["rounds"]:
        rows = r["ent"][r["ent"] >= 0]
        assert ((d[rows] >= r["d0"]) & (d[rows] < r["d0"] + r["nr"])).all()
        placed += rows.tolist()
    assert sorted(placed) == np.flatnonzero(ok).tolist()
    assert sorted(m["stores"]) == list(range(N))
    assert np.array_equal(m["out"].view(np.int32), _accum_numpy(idx, dst, tbl))
