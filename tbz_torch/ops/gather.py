"""Clamped element and row gathers, the port of tbz/ops/gather.py.

tbz routes a 1-D element gather ``x[idx]`` through a width-16 row
gather and a one-hot select on a TPU, because XLA:TPU lowers the 1-D
gather slowly and the row gather fast. A GPU gathers single elements
natively, and the port's kernels do so inside csrc/resolve.cu and
csrc/spans.cu, so here the emulation is kept only as tbz's bit-exact
arithmetic behind ``emu=True``; nothing on the port's paths calls these
functions. They are plain tensor functions on any device, with no
kernel of their own: in tbz too they are XLA gathers outside any Pallas
kernel.
"""

from __future__ import annotations

import torch

_W = 16
_LG = 4


def want_emulation(arr) -> bool:
    """False for every torch tensor: the row-gather emulation works
    around XLA:TPU's slow 1-D gather, and a GPU's native gather (what
    the port's kernels use) needs no such detour."""
    return False


def take1d(x: torch.Tensor, idx: torch.Tensor,
           emu: bool = False) -> torch.Tensor:
    """``x[clamp(idx)]`` for 1-D x and an integer idx of any shape; `emu`
    selects tbz's width-16 row-gather emulation, bit-exact with the
    native gather."""
    if x.dtype == torch.uint32:
        # torch's uint32 support is thin (no arithmetic): gather and sum
        # the same bits as int32
        return take1d(x.view(torch.int32), idx, emu).view(torch.uint32)
    n = x.shape[0]
    idx = idx.long().clamp(0, n - 1)
    if not emu:
        return x[idx]
    pad = (-n) % _W
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    rows = x.reshape(-1, _W)[idx >> _LG]
    oh = torch.arange(_W, device=x.device) == (idx & (_W - 1))[..., None]
    if x.dtype == torch.uint8:
        # multiply in int32, as tbz does (a uint8 one-hot multiply-sum
        # would wrap)
        return (rows.to(torch.int32) * oh).sum(-1).to(torch.uint8)
    return (rows * oh).sum(-1, dtype=x.dtype)


def take_rows(x2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x2[clamp(idx)]``."""
    if x2.dtype == torch.uint32:
        return take_rows(x2.view(torch.int32), idx).view(torch.uint32)
    return x2[idx.long().clamp(0, x2.shape[0] - 1)]
