"""Threefry-2x32 and JAX's bit layout in plain torch ops: the mask PRNG of
the seeded wire formats.

A seeded artifact (`compressed.py`, `public.py`) carries raw threefry key
data, uint32[2], and the receiver regenerates its uniform masks from it.
For the bytes to mean the same thing in `tfhe_tpu` and here, both must
expand a seed to the same words, so this module is a twin of the part of
`jax.random` that the reference's masks go through, and seeded artifacts
cross packages in both directions. (The other choice, seeded forms that
belong to one package each, would make the wire format readable by one
package only.) Only the masks go through threefry: noise and secret draws
stay on `torch.Generator`, as everywhere in the port, and a seeded keygen
draws its mask seed from its generator (`key_from_generator`).

The layout pinned (JAX with `jax_threefry_partitionable` = True, the
default since JAX 0.5; `jax._src.prng._threefry_random_bits_partitionable`
and `_threefry_split_foldlike`):

* `jax.random.bits(key, shape, uint32)`: for the row-major flat index i of
  each element, (w1, w2) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
  and bits = w1 ^ w2;
* `jax.random.split(key, num)`: child key j is the pair (w1, w2) itself
  for the index j.

Words are held in int64 tensors with values in [0, 2^32) (torch's `>>` on
int32 is arithmetic, and its uint32 supports few operations), so every
function runs on any device. Keys are uint32[2] tensors (or any pair of
ints).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key_words(key) -> tuple:
    """The two key words of a uint32[2] key (tensor, array or pair) as
    Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.reshape(-1).cpu().tolist()
    k0, k1 = (int(v) & MASK for v in key)
    return k0, k1


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    (x0, x1) under `key`; words as int64 tensors in [0, 2^32)."""
    k0, k1 = key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _device(key, device):
    if device is not None:
        return device
    return key.device if isinstance(key, torch.Tensor) else "cuda"


def _counter_hash(key, shape, device) -> tuple:
    """threefry2x32 of the (hi, lo) words of the row-major flat index."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=_device(key, device))
    w1, w2 = threefry2x32(key, idx >> 32, idx & MASK)
    return w1.reshape(shape), w2.reshape(shape)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape, jnp.uint32)` as int64 words in
    [0, 2^32), on `device` (default: the key tensor's, else "cuda")."""
    w1, w2 = _counter_hash(key, tuple(shape), device)
    return w1 ^ w2


def uniform_torus32(key, shape, device=None) -> torch.Tensor:
    """`numeric.rand_uniform_torus32` of the reference on a threefry key:
    the bits of `random_bits` as int32 words."""
    bits = random_bits(key, shape, device)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits) \
        .to(torch.int32)


def split(key, num: int = 2, device=None) -> torch.Tensor:
    """`jax.random.split(key, num)` as key data: uint32[num, 2]."""
    w1, w2 = _counter_hash(key, (num,), device)
    return torch.stack([w1, w2], dim=-1).to(torch.uint32)


def key_from_generator(generator: torch.Generator) -> torch.Tensor:
    """A fresh threefry key, uint32[2], drawn from `generator` on its
    device."""
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=generator,
                         device=generator.device).to(torch.uint32)
