"""tbz_torch.ops.gather against tbz.ops.gather (tolerance 0): take1d
with and without tbz's row-gather emulation over int32, uint32 and uint8
at several lengths, indices past both ends, a 2-D index shape,
take_rows, and want_emulation on a CPU tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz.ops import gather as TG
from tbz_torch.ops import gather as PG

from torch_util import GATHER_DTYPES, clamped_gather, gather_case


@pytest.fixture(autouse=True, scope="module")
def _free_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()


def _both(x, idx, emu):
    t = np.asarray(TG.take1d(jnp.asarray(x), jnp.asarray(idx), emu))
    p = PG.take1d(torch.from_numpy(x), torch.from_numpy(idx), emu).numpy()
    return t, p


@pytest.mark.parametrize("emu", [False, True])
@pytest.mark.parametrize("n", [16, 100, 1 << 15])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_take1d_matches_tbz(dtype, n, emu):
    x, idx = gather_case(dtype, n)
    t, p = _both(x, idx, emu)
    assert p.dtype == t.dtype == x.dtype
    np.testing.assert_array_equal(p, t)
    np.testing.assert_array_equal(p, clamped_gather(x, idx))


@pytest.mark.parametrize("emu", [False, True])
def test_take1d_keeps_a_2d_index_shape(emu):
    x, idx = gather_case("uint8", 100, shape=(33, 7))
    t, p = _both(x, idx, emu)
    assert p.shape == t.shape == (33, 7)
    np.testing.assert_array_equal(p, t)


@pytest.mark.parametrize("width", [3, 8, 16])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_take_rows_matches_tbz(dtype, width):
    x, _ = gather_case(dtype, 1000 * width)
    x2 = x.reshape(1000, width)
    idx = np.random.default_rng(31).integers(-40, 1040, 777).astype(np.int32)
    t = np.asarray(TG.take_rows(jnp.asarray(x2), jnp.asarray(idx)))
    p = PG.take_rows(torch.from_numpy(x2), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(p, t)
    np.testing.assert_array_equal(p, clamped_gather(x2, idx))


def test_want_emulation_is_false_for_torch_tensors():
    assert PG.want_emulation(torch.zeros(4, dtype=torch.int32)) is False
    assert TG.want_emulation(jnp.zeros(4, jnp.int32)) is False  # the CPU
