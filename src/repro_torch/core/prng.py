"""Threefry-2x32 counter-based random bits, bit for bit as ``jax.random``
draws them — the priorities of the streaming-propensity reservoir
(``propensity.py:126`` and ``fused.py:278`` of the reference).

The reference draws ``jax.random.uniform(fold_in(PRNGKey(seed), n), (N,))``
under JAX's defaults (``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``). With partitionable threefry element
``i`` of a draw depends only on the key and ``i`` (JAX's
``_threefry_random_bits_partitionable``):

- ``PRNGKey(seed)`` is the word pair ``(0, seed)`` (``threefry_seed``);
- ``fold_in(key, n)`` is ``threefry2x32(key, (0, n))`` (``_threefry_fold_in``);
- the 32 random bits of element ``i`` are ``x0 ^ x1`` where
  ``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
- ``uniform`` keeps the top 23 bits as a mantissa under exponent 0:
  ``bitcast_f32((bits >> 9) | 0x3F800000) - 1.0`` (``random.py:_uniform``).

So a draw does not depend on its length, and the reference's power-of-two
batch padding changes no real row's priority. Keys are two host integers
(a key depends only on the seed and the batch counter, both host values);
the per-element rounds run on the device in int64 tensors masked to 32
bits, since torch lacks unsigned 32-bit arithmetic. That is about 150
small elementwise operations per draw in eager PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32, 20 rounds, on two u32 counter words: Python ints or
    int64 tensors holding values in [0, 2^32). Returns the two output
    words in the same form."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return (0, seed)


def fold_in(key: Key, n: int) -> Key:
    """``jax.random.fold_in(key, n)`` for n in [0, 2^32)."""
    if not 0 <= n <= MASK32:
        raise ValueError(f"fold_in data {n} outside [0, 2^32)")
    return threefry2x32(key, 0, n)


def random_bits(key: Key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """(n,) int64 holding the u32 words ``jax.random.bits(key, (n,))``."""
    dev = resolve_device(device)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    x0, x1 = threefry2x32(key, i >> 32, i & MASK32)
    return x0 ^ x1


def uniform(key: Key, n: int, device: DeviceLike = None) -> torch.Tensor:
    """(n,) float32 equal bit for bit to ``jax.random.uniform(key, (n,))``
    on [0, 1)."""
    bits = random_bits(key, n, device)
    one = (bits >> 9) | 0x3F800000      # < 2^31: fits int32 exactly
    return one.to(torch.int32).view(torch.float32) - 1.0
