"""Several devices: tbz_torch.parallel (mesh, sharded checksums, the
mesh-wide member decode, assign_members) against tbz.parallel on its 8
virtual CPU devices (tests/conftest.py) and against stdlib zlib, on CPU
meshes of the port (make_mesh(devices=["cpu"] * k)), for the cases of
tests/test_parallel.py. Outputs are integers and bytes: tolerance 0."""

import gzip
import zlib

import jax
import numpy as np
import pytest
import torch

from tbz.parallel import distributed as TD
from tbz.parallel import shard as TS
from tbz.parallel.mesh import make_mesh as tbz_mesh
from tbz_torch import checksums as cs
from tbz_torch import errors as PE
from tbz_torch.parallel import distributed as PD
from tbz_torch.parallel import shard as PS
from tbz_torch.parallel.mesh import make_mesh

from torch_util import corpus


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, jax.devices()
    return tbz_mesh(sp=1), make_mesh(devices=["cpu"] * 8)


def _padded(data: bytes, N: int) -> np.ndarray:
    arr = np.zeros(N, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    return arr


CRC_N = 8 * 4096
ADLER_N = 8 * 8192


@pytest.mark.parametrize("n", [0, 1, 5000, CRC_N - 1, CRC_N])
def test_sharded_crc32(meshes, n):
    tm, pm = meshes
    data = corpus(n % 7, n)
    arr = _padded(data, CRC_N)
    want = zlib.crc32(data)
    assert PS.make_sharded_crc32(pm, CRC_N)(arr, np.uint32(n)) == want
    assert int(TS.make_sharded_crc32(tm, CRC_N)(arr, np.uint32(n))) == want


@pytest.mark.parametrize("n", [0, 1, 5000, 40000, ADLER_N])
def test_sharded_adler32(meshes, n):
    tm, pm = meshes
    data = corpus(n % 5 + 1, n)
    arr = _padded(data, ADLER_N)
    want = zlib.adler32(data)
    assert PS.make_sharded_adler32(pm, ADLER_N)(arr, np.uint32(n)) == want
    assert int(TS.make_sharded_adler32(tm, ADLER_N)(arr,
                                                    np.uint32(n))) == want


def test_sharded_crc_odd_lane_count(meshes):
    """Three 128-byte lanes a shard (tbz's front-pad identity path)."""
    tm, pm = meshes
    N = 8 * 128 * 3
    data = corpus(2, N)
    arr = np.frombuffer(data, np.uint8)
    assert PS.make_sharded_crc32(pm, N)(arr, np.uint32(N)) == \
        int(TS.make_sharded_crc32(tm, N)(arr, np.uint32(N))) == \
        zlib.crc32(data)


def test_single_device_mesh_paths():
    """The same code on a one-entry mesh (the one-card configuration)."""
    tm = tbz_mesh(n_devices=1, sp=1)
    pm = make_mesh(n_devices=1, sp=1, devices=["cpu"] * 8)
    assert pm.shape == {"dp": 1, "sp": 1}
    data = corpus(3, 30000)
    payloads = [zlib.compress(data, 9)]
    assert PS.decode_streams_sharded(payloads, pm) == \
        TS.decode_streams_sharded(payloads, tm) == [data]
    arr = _padded(data[:3000], 8192)
    assert PS.make_sharded_crc32(pm, 8192)(arr, 3000) == \
        int(TS.make_sharded_crc32(tm, 8192)(arr, np.uint32(3000))) == \
        zlib.crc32(data[:3000])


@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_sharded_checksums_along_either_axis(axis):
    """A (4, 2) mesh: shards along `axis`, replicated along the other."""
    pm = make_mesh(dp=4, sp=2, devices=["cpu"] * 8)
    ndev = pm.shape[axis]
    N = ndev * 4096
    data = corpus(4, N - 777)
    arr = _padded(data, N)
    assert PS.make_sharded_crc32(pm, N, axis)(arr, len(data)) == \
        zlib.crc32(data)
    assert PS.make_sharded_adler32(pm, N, axis)(arr, len(data)) == \
        zlib.adler32(data)


def test_local_shards_in_mesh_order():
    """x as the list of this process's shards, one per mesh entry in mesh
    order (replicas included), as make_array_from_callback gives tbz."""
    pm = make_mesh(dp=2, sp=2, devices=["cpu"] * 4)
    N = 2 * 4096
    data = corpus(5, N - 100)
    arr = _padded(data, N)
    C = N // 2
    shards = [torch.from_numpy(arr[i * C:(i + 1) * C].copy())
              for i in (0, 0, 1, 1)]
    assert PS.make_sharded_crc32(pm, N)(shards, len(data)) == \
        zlib.crc32(data)
    assert PS.make_sharded_adler32(pm, N)(shards, len(data)) == \
        zlib.adler32(data)
    with pytest.raises(ValueError):
        PS.make_sharded_crc32(pm, N)(shards[:3], len(data))


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_combine_tree_past_2_32(kind):
    """The fold of 7 partials whose lengths sum past 2^32 bytes equals a
    chain of the host combines (64-bit lengths throughout)."""
    rng = np.random.default_rng(9)
    lens = [2**31 + 5, 3, 2**31 - 1, 0, 2**30 + 7, 12345, 2**32 + 9]
    if kind == "crc32":
        vals = [int(v) for v in rng.integers(0, 2**32, len(lens))]
        combine = cs.crc32_combine
    else:
        vals = [int(a) << 16 | int(b) for a, b in
                rng.integers(0, cs.ADLER_MOD, (len(lens), 2))]
        combine = cs.adler32_combine
    assert sum(lens) > 2**32
    want = vals[0]
    for v, n in zip(vals[1:], lens[1:]):
        want = combine(want, v, n)
    got = PS._fold(kind, torch.tensor(vals), torch.tensor(lens))
    assert int(got) == want


def test_assign_members_equals_tbz():
    rng = np.random.default_rng(12)
    for shards in (1, 3, 8):
        sizes = [int(s) for s in rng.integers(1, 10**6, 37)]
        assert PD.assign_members(sizes, shards) == \
            TD.assign_members(sizes, shards)
    sizes = [100, 1, 99, 50, 50, 2]
    groups = PD.assign_members(sizes, 3)
    loads = sorted(sum(sizes[i] for i in g) for g in groups)
    assert loads[-1] - loads[0] <= 100
    assert sorted(i for g in groups for i in g) == list(range(6))


def _outs(outs):
    return [type(o).__name__ if isinstance(o, Exception) else o
            for o in outs]


@pytest.mark.parametrize("k", [1, 3, 8])
def test_decode_streams_sharded_positional_mesh(k):
    """tbz's call, decode_streams_sharded(payloads, mesh, format=...),
    on k-entry meshes of both packages: the same outputs and error
    values, in stream order."""
    tm = tbz_mesh(n_devices=k, sp=1)
    pm = make_mesh(devices=["cpu"] * k)
    streams = [corpus(120 + i, 6000 + 1500 * i) for i in range(7)]
    payloads = [gzip.compress(s, 6) for s in streams]
    payloads.append(gzip.compress(streams[0]) + gzip.compress(streams[1]))
    bad = bytearray(payloads[3])
    bad[-6] ^= 0xFF  # CRC of stream 3
    payloads[3] = bytes(bad)
    mine = PS.decode_streams_sharded(payloads, pm, "gzip", True, True)
    ref = TS.decode_streams_sharded(payloads, tm, format="gzip",
                                    return_errors=True)
    assert _outs(mine) == _outs(ref)
    assert isinstance(mine[3], PE.ChecksumError)
    assert mine[:3] + mine[4:7] == streams[:3] + streams[4:]
    assert mine[7] == streams[0] + streams[1]


def test_rows_split_into_dp_blocks():
    """A bucket of 5 rows on a 3-entry mesh: padded to 6, blocks of 2
    rows (the last holds one), as P("dp") places them; each block's
    rows are resolved on its own entry."""
    pm = make_mesh(devices=["cpu"] * 3)
    assert [b[1:3] for b in PS._row_blocks(pm, 5)] == [(0, 2), (2, 4),
                                                      (4, 5)]
    assert [b[1:3] for b in PS._row_blocks(pm, 1)] == [(0, 1), (1, 1),
                                                      (1, 1)]
    streams = [corpus(130 + i, 5000 + 999 * i) for i in range(5)]
    payloads = [zlib.compress(s, 6) for s in streams]
    outs = PS.decode_streams_sharded(payloads, pm, device_resident=True)
    assert [b"".join(r[:n].numpy().tobytes() for r, n in o)
            for o in outs] == streams


REJECTED = {
    "crc_align": lambda mod, m: mod.make_sharded_crc32(m, 8 * 100),
    "adler_align": lambda mod, m: mod.make_sharded_adler32(m, 8 * 2048),
    "axis": lambda mod, m: mod.make_sharded_crc32(m, 8 * 4096, "tp"),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_value_error_where_tbz_rejects(meshes, case):
    """The shapes tbz rejects (an assertion, or a missing axis) raise
    ValueError in the port."""
    tm, pm = meshes
    with pytest.raises((AssertionError, KeyError)):
        REJECTED[case](TS, tm)
    with pytest.raises(ValueError):
        REJECTED[case](PS, pm)


def test_mesh_shape_tbz_rejects_raises_value_error():
    with pytest.raises(AssertionError):
        tbz_mesh(dp=3, sp=3)
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=3, devices=["cpu"] * 8)


def test_call_checks_n_and_length(meshes):
    _, pm = meshes
    fn = PS.make_sharded_crc32(pm, CRC_N)
    with pytest.raises(ValueError):
        fn(np.zeros(CRC_N, np.uint8), CRC_N + 1)
    with pytest.raises(ValueError):
        fn(np.zeros(CRC_N - 128, np.uint8), 0)


def test_mesh_config_knobs(monkeypatch):
    """TBZ_TORCH_MESH_DP / TBZ_TORCH_MESH_SP, as tbz's TBZ_MESH_*."""
    from tbz_torch.utils import config as C
    saved = C.get_config()
    monkeypatch.setenv("TBZ_TORCH_MESH_DP", "2")
    monkeypatch.setenv("TBZ_TORCH_MESH_SP", "3")
    try:
        C.set_config(C.Config.from_env())
        assert make_mesh(devices=["cpu"] * 8).shape == {"dp": 2, "sp": 3}
        assert make_mesh(sp=1, devices=["cpu"] * 8).shape == \
            {"dp": 2, "sp": 1}
        assert make_mesh(devices=["cpu"] * 4).shape == {"dp": 1, "sp": 3}
    finally:
        C.set_config(saved)


def test_make_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.global_mesh()


def test_global_mesh_without_group_is_local():
    m = PD.global_mesh(dp=2, sp=2, local_devices=["cpu"] * 4)
    assert m.shape == {"dp": 2, "sp": 2} and m.group is None
    assert m.is_local()
    PD.initialize("127.0.0.1:1", 1, 0)   # one process: a no-op
    with pytest.raises(ValueError):
        PD.global_mesh(dp=3, local_devices=["cpu"] * 4)
