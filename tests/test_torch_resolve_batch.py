"""Kernel 7 parity: tbz_torch's plain batched resolve (_resolve_batch on
CPU tensors) against tbz.parallel.shard._resolve_batch (XLA on the CPU)
on batches whose rows have very different depths: the same bytes in every
row and the same doubling pass count (tbz's vmapped while_loop runs its
deepest row's passes). Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz.ops import resolve as TR
from tbz.parallel import shard as TS
from tbz_torch import reference as PRef
from tbz_torch.ops import resolve as PR

from test_torch_resolve import padded_args, tbz_pass_count
from torch_util import (corpus, raw_deflate, resolve_batch_case,
                        stage_resolve_batch)


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()


def _check(monkeypatch, rows, cap):
    ol, di, rv, nt, tot, inp, win, cap = stage_resolve_batch(rows, cap)
    got, passes = PR._resolve_batch(
        *(torch.from_numpy(a) for a in (ol, di, rv, nt)), tot,
        torch.from_numpy(inp), torch.from_numpy(win), cap)
    ref = np.asarray(TS._resolve_batch(
        jnp.asarray(ol), jnp.asarray(di), jnp.asarray(rv), jnp.asarray(nt),
        jnp.asarray(tot, jnp.int32), jnp.asarray(inp), jnp.asarray(win),
        out_capacity=cap))
    deepest = 1
    for r, (tape, i, w, want) in enumerate(rows):
        assert got[r, :len(want)].numpy().tobytes() == want
        assert np.array_equal(ref[r, :len(want)], got[r, :len(want)].numpy())
        a = padded_args(tape, i, w)
        row_passes, _ = tbz_pass_count(
            monkeypatch, TR._resolve_impl, *(jnp.asarray(x) for x in a[:3]),
            jnp.int32(a[3]), jnp.int32(tape.total_out), jnp.asarray(a[4]),
            jnp.asarray(a[5]), cap)
        deepest = max(deepest, row_passes)
    assert passes == deepest
    return passes


def test_adversarial_rows(monkeypatch):
    """A deep distance-1 run, an empty row, a far-chain row with a preset
    window that fills the capacity exactly, a stored row, 100 literals."""
    rows, cap = resolve_batch_case(3)
    assert rows[2][0].total_out == cap and len(rows[1][0]) == 0
    assert _check(monkeypatch, rows, cap) > 10


def test_stream_rows(monkeypatch):
    """Tapes of zlib streams at levels 1, 6 and 9, one with a preset
    window, beside a row of stored blocks."""
    rows = []
    for i, level in enumerate((1, 6, 9, 0)):
        window = corpus(60 + i, 20000) if level == 9 else b""
        data = corpus(50 + i, 60000 + 7000 * i)
        payload = raw_deflate(data, level, zdict=window or None)
        tape = PRef.tokenize_host(payload, 0, window_len=len(window)).tape
        rows.append((tape, payload, window, data))
    cap = PR._pad_pow2(max(t.total_out for t, *_ in rows), floor=4096)
    _check(monkeypatch, rows, cap)
