"""Training dropout masks, drawn by a Philox4x32-10 written out in PyTorch.

The CUDA kernels draw the same masks with ``csrc/philox.cuh``, bit for bit,
so a kernel and its plain version agree under dropout. The TPU kernels'
bits (``pltpu.prng_random_bits``) cannot be reproduced, and this design
does not try to; what it keeps from ``scann_tpu/kernels/scann_forward.py:
make_dropout_masks`` is the property that a molecule's masks depend only
on (seed, global molecule index, stream), never on the batch tiling.

An element of a mask is keyed on (seed, molecule) and counted by
(element index // 4, stream, 0, 0); it takes word element index % 4 of the
output and is kept when that word is below ``uint32(keep * (2**32 - 1))``,
then scaled by ``1 / keep`` (``scann_forward.py:196-200``). Streams: 0 is
the embedding mask [M, D], ``1 + l`` the residual mask of layer l [M, D],
``1 + L + l`` the attention mask of layer l [M, N, H].

The 32x32 -> 64-bit products are done exactly on int64 by splitting one
factor into 16-bit halves (a plain int64 product would overflow).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    ``b`` (int64 holding uint32 values)."""
    p_lo = a * (b & 0xFFFF)                     # < 2**48
    p_hi = a * (b >> 16)                        # < 2**48
    t = ((p_hi & 0xFFFF) << 16) + p_lo          # < 2**49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 values;
    returns the four output words, broadcast to a common shape."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(x, dtype=torch.int64)
                              for x in (c0, c1, c2, c3, k0, k1))
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    shape = torch.broadcast_shapes(c0.shape, c1.shape, c2.shape, c3.shape)
    return tuple(x.expand(shape) for x in (c0, c1, c2, c3))


def keep_threshold(rate: float) -> int:
    """uint32 threshold a word must stay below for its element to be kept."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def keep_scale(rate: float) -> float:
    """The float32 factor a kept element is scaled by."""
    return float(np.float32(1.0 / (1.0 - rate)))


def mask_bits(seed: int, mol: torch.Tensor, stream: int, n_elems: int) -> torch.Tensor:
    """The mask words of elements 0..n_elems-1 of ``stream`` for each
    molecule index in ``mol`` [B] -> int64 [B, n_elems]."""
    quads = torch.arange((n_elems + 3) // 4, dtype=torch.int64, device=mol.device)
    words = philox4x32_10(quads[None, :], stream, 0, 0, int(seed) & _MASK32,
                          (mol.to(torch.int64) & _MASK32)[:, None])
    return torch.stack(words, dim=-1).reshape(mol.shape[0], -1)[:, :n_elems]


def dropout_mask(seed: int, mol: torch.Tensor, stream: int, shape, rate: float) -> torch.Tensor:
    """Scaled keep mask [B, *shape] (float32: 0 or 1/keep) of one stream."""
    n = int(np.prod(shape))
    bits = mask_bits(seed, mol, stream, n)
    keep = (bits < keep_threshold(rate)).to(torch.float32) * keep_scale(rate)
    return keep.reshape(mol.shape[0], *shape)


class DropoutMasks(NamedTuple):
    """Every mask of one training forward, already scaled by 1/keep.

    embed [B, M, D]; layers: L x [B, M, D]; attn: L x [B, M, N, H] or None
    (attention dropout runs only under ``use_drop``)."""

    embed: torch.Tensor
    layers: List[torch.Tensor]
    attn: Optional[List[torch.Tensor]]


def make_dropout_masks(seed: int, mol_base: int, B: int, M: int, N: int, D: int, H: int,
                       n_layers: int, rate: float, attn_rate: float = 0.0,
                       device="cpu") -> DropoutMasks:
    """The masks the kernels draw for molecules mol_base .. mol_base+B-1."""
    mol = torch.arange(mol_base, mol_base + B, dtype=torch.int64, device=device)
    embed = dropout_mask(seed, mol, 0, (M, D), rate)
    layers = [dropout_mask(seed, mol, 1 + l, (M, D), rate) for l in range(n_layers)]
    attn = None
    if attn_rate > 0.0:
        attn = [dropout_mask(seed, mol, 1 + n_layers + l, (M, N, H), attn_rate)
                for l in range(n_layers)]
    return DropoutMasks(embed, layers, attn)
