"""Counter-based PRNG: a PyTorch port of ``jax.random``'s threefry2x32.

The reference engine draws every sampled token from ``jax.random`` under
the default ``threefry2x32`` implementation with partitionable random
bits.  These functions compute the same bits, so a sampled rollout of
the port is the reference's draw for draw:

  * a key is a ``(..., 2)`` tensor of 32-bit words (``int64`` holding
    0 .. 2^32 - 1), on any device; every function is vectorized over
    the leading dimensions of its keys;
  * ``prng_key(seed)`` = ``jax.random.PRNGKey(seed)``: ``(0, seed mod
    2^32)``;
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key;
  * ``random_bits(key, shape)`` hashes the 64-bit iota of ``shape``
    (high word, low word) and XORs the two output words;
  * ``uniform`` puts the top 23 bits into a float's mantissa in [1, 2),
    subtracts 1, scales and shifts with one rounding (XLA's fused
    multiply-add) and clamps to ``minval``; ``gumbel`` is jax's
    "low" mode (its default): ``-log(-log(uniform(tiny, 1)))``, the logs
    in float64;
  * ``categorical(key, logits)`` = ``argmax(gumbel + logits)``.

torch has no unsigned 32-bit arithmetic on every device, so the words
live in ``int64`` and every add and rotate is masked to 32 bits.  All
keys and all counters are hashed at once: one draw costs a fixed number
of elementwise launches, whatever its shape.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    broadcast of its four int64 word tensors; returns the two output
    words."""
    k1, k2 = k1.long(), k2.long()
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1.long() + ks[0]) & _M32
    x2 = (x2.long() + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds: the high word is 0)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and 32-bit
    ``data`` (an int, or a tensor broadcasting against ``key[..., 0]``;
    taken mod 2^32)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words (int64) of shape ``key.shape[:-1] + shape``:
    ``bits1 ^ bits2`` of the cipher over the iota of ``shape``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    hi = (count >> 32).reshape(shape)
    lo = (count & _M32).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: [minval, maxval)."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 on the host (no
    # device copy); the scale-and-shift rounds once, as XLA's fused
    # multiply-add does (exact in float64, then one rounding)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    lo = float(lo)
    return (floats.double() * span + lo).float().clamp_min(lo)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (jax's default).  The
    two logs run in float64 and round once: the float32 logs of the CPU
    and of XLA each err by an ulp, which the outer log magnifies where
    -log(u) is near 1 or near 0; in float64 the result lies within 2 ulp
    of max(|g|, 1) of the reference's."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return (-torch.log(-torch.log(u.double()))).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw over the last axis.  ``key`` (..., 2) leads ``logits``: its
    leading shape is a prefix of the logits' leading shape, and each key
    draws the noise of the logits below it (one (2,) key for the whole
    array, as the reference's single call, or one key per row, as its
    ``vmap``); ties go to the lower index, as ``jnp.argmax`` breaks
    them."""
    g = gumbel(key, logits.shape[key.ndim - 1:])
    return torch.argmax(g + logits, dim=-1)
