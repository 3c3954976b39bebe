"""The sequential device tokenizer's plain version against
tbz.ops.tokenize_device.tokenize_device_impl (XLA on the CPU): all eight
outputs (the tape arrays, n_tok, produced, end_bit, err, finished)
exactly equal, tolerance 0 (integers). Plus the host wrapper's error
classes, the tape-overflow retry, the code-length table's single-1-bit
rule, the frontend dispatch, and build_flat_table's allow_single flag.

Every call of tbz's jitted impl in one test shares one buffer shape and
one T, so XLA compiles a few shapes only."""

import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz import reference as TR
from tbz.errors import DeflateError as TDeflateError
from tbz.errors import TruncatedError as TTruncatedError
from tbz.ops import tokenize_device as TT
from tbz_torch import errors as PE
from tbz_torch import frontend as PF
from tbz_torch import reference as PR
from tbz_torch.ops import tokenize_device as PT

from torch_util import bad_cl_repeat_header, corpus, raw_deflate, short_blocks


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module: each holds
    hundreds of memory maps, and the whole suite runs in one process,
    under the kernel's limit of 65530 maps."""
    yield
    jax.clear_caches()


def _buffer(payload: bytes, nbytes: int) -> np.ndarray:
    """payload in a zeroed buffer of nbytes (>= len + 8), as words."""
    buf = np.zeros(-(-nbytes // 4) * 4, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    return buf.view("<u4")


def _both(payload: bytes, T: int, window_len: int = 0, nbytes=None):
    """(tbz's eight outputs, the port's) as lists of int64 arrays."""
    words = _buffer(payload, nbytes or len(payload) + 8)
    nbits = len(payload) * 8
    want = TT.tokenize_device_impl(jnp.asarray(words), np.int32(nbits),
                                   np.int32(window_len), T)
    tape, res = PT.tokenize_device_impl(
        torch.from_numpy(words.view(np.int32).copy()), nbits, window_len, T)
    got = [tape[0], tape[1], tape[2]] + list(res)
    return ([np.asarray(x).astype(np.int64) for x in want],
            [np.asarray(x).astype(np.int64) for x in got])


def _assert_same(payload, T, window_len=0, nbytes=None):
    want, got = _both(payload, T, window_len, nbytes)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), i
    return [int(x) for x in got[3:]]  # n_tok, produced, end_bit, err, fin


def _T(payload):
    return 1 << max(10, len(payload).bit_length())


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_levels(level):
    payload = raw_deflate(corpus(60, 1 << 14), level)
    n_tok, produced, end_bit, err, fin = _assert_same(payload, _T(payload))
    assert err == 0 and fin == 1 and produced == 1 << 14
    assert end_bit <= len(payload) * 8


def test_static_only():
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    payload = co.compress(corpus(61, 12 << 10)) + co.flush()
    assert _assert_same(payload, _T(payload))[3] == 0


@pytest.mark.parametrize("case", ["short_blocks", "bad_cl_repeat"])
def test_short_blocks_and_bad_repeat(case):
    """Many short dynamic blocks with empty stored blocks between them
    (flushes), and a dynamic header whose first code-length symbol
    repeats nothing (ERR_BAD_CL_REPEAT)."""
    payload = (short_blocks(64, 12 << 10) if case == "short_blocks"
               else bad_cl_repeat_header())
    err = _assert_same(payload, _T(payload))[3]
    assert err == (0 if case == "short_blocks" else PE.ERR_BAD_CL_REPEAT)


def test_window():
    """A preset dictionary: distances reach into the window, and with
    window_len = 0 the same tape ends in ERR_BAD_DISTANCE."""
    zdict = corpus(62, 4 << 10)
    data = zdict[:3000] + corpus(63, 8 << 10)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict)
    payload = co.compress(data) + co.flush()
    assert _assert_same(payload, _T(payload), len(zdict))[3] == 0
    assert _assert_same(payload, _T(payload), 0)[3] == PE.ERR_BAD_DISTANCE


def _classify(fn, payload):
    try:
        fn(payload)
        return "ok"
    except (PE.TruncatedError, TTruncatedError):
        return "trunc"
    except (PE.DeflateError, TDeflateError):
        return "err"


def _port(payload):
    return PT.tokenize_device(payload, device="cpu")


def test_error_class_sweep():
    """Bit flips: every output equal to tbz's impl, and the wrapper's
    error class equal to the oracle's (tests/test_tokenize_device.py)."""
    rng = random.Random(5)
    payload = bytearray(raw_deflate(corpus(64, 1 << 11), 9))
    T = _T(payload)
    errs = set()
    for _ in range(40):
        i = rng.randrange(len(payload))
        b = 1 << rng.randrange(8)
        payload[i] ^= b
        p = bytes(payload)
        errs.add(_assert_same(p, T)[3])
        assert _classify(_port, p) == _classify(TR.tokenize_host, p), i
        payload[i] ^= b
    assert len(errs) > 2  # the sweep reaches several error codes


def test_truncation_sweep():
    payload = raw_deflate(corpus(65, 1 << 10), 9)
    T = _T(payload)
    for cut in range(0, len(payload), 17):
        p = payload[:cut]
        # one buffer shape for every cut (bytes past the cut are zero, as
        # tbz's clamped reads past its own buffer are)
        _assert_same(p, T, nbytes=len(payload) + 8)
        assert _classify(_port, p) == _classify(TR.tokenize_host, p), cut
    with pytest.raises(PE.TruncatedError):
        _port(payload[:len(payload) // 2])


def test_tape_overflow_retry():
    payload = raw_deflate(corpus(66, 4 << 10), 6)
    n_tok, produced, _, err, _ = _assert_same(payload, 64)
    assert err == PE.ERR_TAPE_OVERFLOW and n_tok == 64
    small = PT.tokenize_device(payload, T=64, device="cpu")
    full = PT.tokenize_device(payload, device="cpu")
    want = TR.tokenize_host(payload)
    for r in (small, full):
        assert np.array_equal(r.tape.out_len, want.tape.out_len)
        assert np.array_equal(r.tape.dist, want.tape.dist)
        assert np.array_equal(r.tape.root_val, want.tape.root_val)
        assert r.end_bit == want.end_bit and r.finished


def _single_bit_cl_header() -> bytes:
    """A dynamic header whose code-length code is ONE 1-bit code (for
    symbol 16), then a 0 bit: tbz (and zlib) reject the code-length code
    as incomplete; with zlib's single-code exception the machine would
    instead decode a repeat with no previous length."""
    bits = [1, 0, 1]                                 # BFINAL, BTYPE = 2
    bits += [0] * 5 + [0] * 5 + [0] * 4              # HLIT, HDIST, HCLEN=4
    for v in (1, 0, 0, 0):                           # lens of 16, 17, 18, 0
        bits += [(v >> k) & 1 for k in range(3)]
    bits += [0] * 8
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def test_single_one_bit_cl_code_is_rejected():
    payload = _single_bit_cl_header()
    assert _assert_same(payload, 1024)[3] == PE.ERR_BAD_HUFFMAN
    with pytest.raises(PE.DeflateError) as e:
        _port(payload)
    assert e.value.code == PE.ERR_BAD_HUFFMAN
    with pytest.raises(zlib.error, match="code lengths"):
        zlib.decompressobj(-15).decompress(payload)
    # the flag decides it: the same CL lengths pass with allow_single
    cl = torch.zeros(1, 19, dtype=torch.int32)
    cl[0, 16] = 1
    consts = torch.from_numpy(PT._entry_consts()[2].view(np.int32))
    assert int(PT._build_flat_table_plain(cl, consts, False)[1][0]) == \
        PE.ERR_BAD_HUFFMAN
    assert int(PT._build_flat_table_plain(cl, consts, True)[1][0]) == 0


@pytest.mark.parametrize("n_syms,allow_single", [
    (19, False), (19, True), (288, False), (288, True), (32, True)])
def test_build_flat_table_allow_single(n_syms, allow_single):
    """The plain builder with allow_single both ways against tbz's, on a
    single 1-bit code, a single 2-bit code, a complete code and none."""
    kind = {19: 2, 288: 0, 32: 1}[n_syms]
    consts = PT._entry_consts()[kind]
    rows = np.zeros((4, n_syms), np.int32)
    rows[0, n_syms - 1] = 1
    rows[1, 3] = 2
    rows[2, :2] = 1
    for lens in rows:
        want_t, want_e = TT.build_flat_table(jnp.asarray(lens),
                                             jnp.asarray(consts), n_syms,
                                             allow_single)
        got_t, got_e = PT._build_flat_table_plain(
            torch.from_numpy(lens[None]),
            torch.from_numpy(consts.view(np.int32)), allow_single)
        assert int(got_e[0]) == int(want_e)
        if int(want_e) == 0:
            assert np.array_equal(got_t[0].numpy(),
                                  np.asarray(want_t).view(np.int32))


def test_frontend_dispatch():
    data = b"device dispatch check " * 50
    payload = zlib.compress(data, 9)[2:-4]
    want = PR.tokenize_host(payload, 0)
    for fe in ("device", "auto", "native", "python"):
        r = PF.tokenize(payload, frontend=fe, device="cpu")
        assert r.finished and r.end_bit == want.end_bit, fe
        assert np.array_equal(r.tape.out_len, want.tape.out_len), fe
        assert np.array_equal(r.tape.dist, want.tape.dist), fe
        assert np.array_equal(r.tape.root_val, want.tape.root_val), fe
    with pytest.raises(ValueError):
        PF.tokenize(payload, frontend="nonsense")
    with pytest.raises(ValueError):
        PF.tokenize(payload, bit_pos=3, frontend="device", device="cpu")


def test_device_tokenizer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        PT.tokenize_device(raw_deflate(b"abc" * 10, 6))
