"""Kernel 7's on-chip path (csrc/resolve.cu onchip_rows: a row of at most
ONCHIP_CAP bytes resolved in one block's shared memory), modelled step
by step on the CPU (torch_util.onchip_model) and held to the plain
batched resolve (ops/resolve._resolve_batch_plain): every byte of the
row and the pass count. The kernel itself runs only on a card
(test_torch_cuda.py). Tolerance 0."""

import numpy as np
import pytest
import torch

from tbz_torch import reference as PRef
from tbz_torch.ops import resolve as PR

import torch_util as TU
from torch_util import (corpus, onchip_model, raw_deflate, resolve_batch_case,
                        resolve_case, stage_resolve_batch)

CAP = TU.ONCHIP_CAP


def _rows(case: str):
    if case == "adversarial":
        rows, cap = resolve_batch_case(7, CAP)
        return rows + [resolve_case("stored", 10, CAP)], cap
    if case == "deep_full":
        return [resolve_case("deep", 9, CAP)], CAP
    rows = []
    for i, level in enumerate((1, 6, 9)):
        window = corpus(80 + i, 20000) if level == 9 else b""
        data = corpus(70 + i, 40000 + 9000 * i)
        payload = raw_deflate(data, level, zdict=window or None)
        tape = PRef.tokenize_host(payload, 0, window_len=len(window)).tape
        rows.append((tape, payload, window, data))
    return rows, CAP


def _fuzz_row(seed: int):
    """A random tape: literals, stored runs, zero-length tokens, matches
    of 1-11 bytes at distances of 1-3 or into the window."""
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([4096, 5000, 8200, 65535, CAP]))
    total = int(rng.integers(0, cap + 1))
    ol, di, rv, n = [], [], [], 0
    while n < total:
        r, k = rng.random(), int(min(rng.integers(1, 12), total - n))
        if r < 0.3:
            k = 1
            ol.append(1), di.append(0), rv.append(int(rng.integers(256)))
        elif r < 0.4:
            ol.append(k), di.append(0)
            rv.append(TU.STORED_FLAG | int(rng.integers(0, 100)))
        else:
            far = rng.random() < 0.5
            ol.append(k), rv.append(0)
            di.append(int(rng.integers(1, min(n + 32768, 40000) + 1)) if far
                      else int(rng.integers(1, 4)))
        n += k
    for _ in range(5):
        i = int(rng.integers(0, len(ol) + 1))
        ol.insert(i, 0), di.insert(i, 0), rv.insert(i, 7)
    T = max(1024, len(ol))
    arr = np.zeros((3, T), np.int32)
    arr[:, :len(ol)] = (ol, di, rv)
    inp = rng.integers(0, 256, 150, dtype=np.uint8)
    win = rng.integers(0, 256, 32768, dtype=np.uint8)
    return arr, len(ol), inp, win, cap


@pytest.mark.parametrize("case", ("adversarial", "deep_full", "streams"))
def test_onchip_model_equals_plain(case):
    """Rows of the card test at cap 65,536 (a deep run of half the
    capacity, an empty row, a far-chain row with a preset window that
    fills the capacity, a stored row, 100 literals, a stored row of the
    whole capacity), a deep run of the whole capacity (15 passes), and
    zlib tapes at levels 1, 6 and 9 (one with a preset window)."""
    rows, cap = _rows(case)
    ol, di, rv, nt, tot, inp, win, cap = stage_resolve_batch(rows, cap)
    plain, passes = PR._resolve_batch_plain(
        *(torch.from_numpy(a) for a in (ol, di, rv, nt)),
        torch.from_numpy(inp), torch.from_numpy(win), cap)
    most = 1
    for r, (*_, want) in enumerate(rows):
        got, p = onchip_model(ol[r], di[r], rv[r], nt[r], inp[r], win[r], cap)
        assert np.array_equal(got, plain[r].numpy()), r
        assert got[:len(want)].tobytes() == want
        most = max(most, p)
    assert most == passes
    if case == "adversarial":
        assert passes == 14
    if case == "deep_full":
        assert passes == 15


@pytest.mark.parametrize("seed", range(6))
def test_onchip_model_equals_plain_on_random_tapes(seed):
    arr, nt, inp, win, cap = _fuzz_row(seed)
    got, p = onchip_model(*arr, nt, inp, win, cap)
    plain, pp = PR._resolve_core_plain(
        *(torch.from_numpy(a) for a in arr), nt, torch.from_numpy(inp),
        torch.from_numpy(win), cap)
    assert np.array_equal(got, plain[PR.W:].numpy()) and p == pp


def test_onchip_constants_are_the_kernels():
    """The model reads its constants from resolve.cu; the on-chip cap
    takes a BGZF block's 64 KiB (SAMv1 4.1) with 16-bit parents, and the
    kernel's shared memory at ONCHIP_CAP fits the 232,448 bytes a block
    can have."""
    src = open(TU.RESOLVE_CU).read()
    assert TU.ONCHIP_CAP == 1 << 16
    assert "constexpr uint16_t SETTLED = 0xFFFF;" in src
    assert "constexpr int ON_CHUNK = 2 * ON_THREADS;" in src
    dynamic = 3 * TU.ONCHIP_CAP + 3 * 2 * TU.ON_THREADS * 4
    static = 32 * 8 + 4   # wsum, deep_sh
    assert dynamic + static <= 232448
