"""Kernel 1 parity: tbz_torch's flat decode tables against
tbz.ops.tokenize_device.build_flat_table (XLA on the CPU).

Tables must be exactly equal where err == 0, and err equal everywhere
(a table with err != 0 is never read). Tolerance 0: integers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz import constants as TC
from tbz.ops import tokenize_device as TD
from tbz_torch.ops import tokenize_device as PD

from torch_util import adversarial_tables, complete_code, every_length_code


ROWS = 8  # every batch padded to one shape: one XLA compile per alphabet


@functools.lru_cache(maxsize=None)
def _jax_builder(n_syms: int):
    lit_c, dist_c, _ = TD._entry_consts()
    consts = jnp.asarray(lit_c if n_syms == 288 else dist_c)
    return jax.jit(jax.vmap(
        lambda ln: TD.build_flat_table(ln, consts, n_syms, True)))


def _jax_tables(lens: np.ndarray, n_syms: int):
    pad = np.zeros((ROWS, n_syms), np.int32)
    pad[:len(lens)] = lens
    tabs, errs = _jax_builder(n_syms)(jnp.asarray(pad))
    n = len(lens)
    return np.asarray(tabs)[:n].view(np.int32), np.asarray(errs)[:n]


def _check(lit: np.ndarray, dist: np.ndarray):
    lt, dt, le, de = PD.build_flat_table(torch.from_numpy(lit),
                                         torch.from_numpy(dist))
    for mine, mine_err, lens, n in ((lt, le, lit, 288), (dt, de, dist, 32)):
        want, want_err = _jax_tables(lens, n)
        assert np.array_equal(mine_err.numpy(), want_err)
        ok = want_err == 0
        assert np.array_equal(mine.numpy()[ok], want[ok])
    return le.numpy(), de.numpy()


def test_fixed_tables():
    lit = TC.FIXED_LITLEN_LENGTHS[None].astype(np.int32)
    dist = TC.FIXED_DIST_LENGTHS[None].astype(np.int32)
    le, de = _check(lit, dist)
    assert le[0] == 0 and de[0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_complete_codes(seed):
    rng = np.random.default_rng(seed)
    lit = np.stack([complete_code(rng, 288, int(rng.integers(2, 287)))
                    for _ in range(6)])
    dist = np.stack([complete_code(rng, 32, int(rng.integers(2, 31)))
                     for _ in range(6)])
    le, de = _check(lit, dist)
    assert not le.any() and not de.any()


def test_oversubscribed_and_incomplete():
    rng = np.random.default_rng(5)
    over = complete_code(rng, 288, 200)
    over[np.flatnonzero(over == 0)[:3]] = 4          # one code too many
    incomplete = complete_code(rng, 288, 100)
    incomplete[np.flatnonzero(incomplete)[0]] = 0    # drop one leaf
    lit = np.stack([over, incomplete])
    dist = np.stack([complete_code(rng, 32, 30), np.zeros(32, np.int32)])
    dist[1, [0, 1]] = [1, 2]                          # incomplete dist
    le, de = _check(lit, dist)
    assert list(le) == [4, 4] and list(de) == [0, 4]


def test_single_one_bit_code_and_empty():
    lit = np.zeros((3, 288), np.int32)
    lit[0, 256] = 1                  # single 1-bit code: allowed
    lit[1, 65] = 2                   # single 2-bit code: incomplete
    dist = np.zeros((3, 32), np.int32)
    dist[0, 3] = 1
    dist[1, [0, 1]] = 1
    le, de = _check(lit, dist)       # row 2: empty, err 0, all invalid
    assert list(le) == [0, 4, 0] and list(de) == [0, 0, 0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_length_present(seed):
    """Complete codes with every length 1-15 present, in both
    alphabets."""
    rng = np.random.default_rng(seed)
    lit = np.stack([every_length_code(rng, 288) for _ in range(4)])
    dist = np.stack([every_length_code(rng, 32) for _ in range(4)])
    for row in (*lit, *dist):
        assert set(row[row > 0]) == set(range(1, 16))
    le, de = _check(lit, dist)
    assert not le.any() and not de.any()


@pytest.mark.parametrize("seed", [1, 2])
def test_adversarial_rows(seed):
    """The rows the card's kernel is held to: long codes, a single 1-bit
    code, over-subscribed and incomplete sets, padding, the fixed code."""
    lit, dist = adversarial_tables(seed)
    le, de = _check(lit, dist)
    assert list(le) == list(de) == [0, 0, 0, 4, 4, 0, 0, 0]
