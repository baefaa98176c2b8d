"""Threefry-2x32 random draws in torch integer ops.

The device chain block (``core.device_explore``) draws its moves and its
accept tests from per-chain threefry keys. This module reproduces the JAX
package's draws bit for bit, under the defaults that package runs with:
the ``threefry2x32`` PRNG, the partitionable ("fold-like") key split and
random bits, and the low-range Gumbel sampler. A key is a ``(..., 2)``
int64 tensor holding two unsigned 32-bit words; every intermediate is an
int64 masked to 32 bits, so the same calls give the same bits on the CPU and
on a CUDA card.

  * :func:`prng_key` — ``PRNGKey(seed)``: the key ``(0, seed)``;
  * :func:`fold_in` — a key per data word: threefry of the counter
    ``(0, data)``;
  * :func:`split` — ``n`` keys: threefry of the counters ``(0, 0 .. n-1)``;
  * :func:`uniform` — f32 in [minval, maxval): 23 random mantissa bits under
    the exponent of 1.0, less 1, scaled and shifted, floored at ``minval``;
  * :func:`categorical` — argmax over the last axis of Gumbel noise
    ``-log(-log(uniform(tiny, 1)))`` plus the logits, the first index on
    ties.

The arithmetic of the 32-bit words is exact, so keys, random bits and
uniforms are bit for bit the reference's. The Gumbel noise goes through
``log``, whose last bit may differ between math libraries; a categorical
draw differs only where two candidates lie within such a bit of each other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["categorical", "fold_in", "prng_key", "random_bits", "split", "threefry2x32",
           "uniform"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000  # f32 1.0
_MANT = 23  # f32 mantissa bits


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on 32-bit words held in
    int64 tensors; all four arguments broadcast. Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)`` for a 32-bit seed: the key ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in(key, d)`` for each 32-bit word ``d`` of ``data``: keys of
    shape ``data.shape + (2,)`` (``key`` broadcasts against ``data``)."""
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``split(key, n)`` (fold-like): ``(..., 2)`` keys to ``(..., n, 2)``."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key: the two cipher
    words of the element's flat index, XOR-ed. Returns ``key.shape[:-1] +
    shape`` int64 words."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    return (y0 ^ y1).reshape(tuple(lead) + tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval) for each key (``key.shape[:-1] +
    shape``)."""
    bits = random_bits(key, shape)
    fbits = ((bits >> (32 - _MANT)) | _ONE_BITS).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # the bounds as f32 values, passed as scalars (no copy to the device)
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (floats * scale + lo).clamp(min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise (the low-range sampler), f32."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per key from ``softmax(logits)`` over the last axis (Gumbel
    max; the first index on ties): ``key`` is ``(..., 2)``, ``logits``
    ``(..., M)``; returns ``(...)`` int64."""
    return torch.argmax(gumbel(key, (logits.shape[-1],)) + logits, -1)
