"""JAX's threefry PRNG and categorical sampler, bit for bit, on integer torch ops.

The sampling paths of the JAX package draw their keys and noise with
`jax.random` (`models/decode.py:671-687`, `runtime/decode_server.py:1014-
1024`). These are the same functions, written out so that the port's keys,
bits and uniforms equal JAX's exactly on any device, with no
`torch.Generator` anywhere. The forms are those `jax 0.9.0` uses by default
(`jax_threefry_partitionable` on):

- `threefry_2x32`: `jax/_src/prng.py::_threefry2x32_lowering` (20 rounds,
  rotations (13, 15, 26, 6) / (17, 29, 16, 24), key schedule k0, k1,
  k0 ^ k1 ^ 0x1BD11BDA);
- `PRNGKey`: `_threefry_seed` (:817), a key [0, seed mod 2^32] (JAX runs
  32-bit, so the high word is 0);
- `split`: `_threefry_split_foldlike` (:1156), counters the 64-bit iota as
  (hi, lo) words;
- `fold_in`: `_threefry_fold_in` (:1168), the hash of the counter pair
  (0, data);
- `random_bits`: `_threefry_random_bits_partitionable` (:1184), 32-bit
  bits = bits1 ^ bits2 over the flat (row-major) index of the shape;
- `uniform`, `gumbel` (mode "low") and `categorical` (with replacement):
  `jax/_src/random.py::_uniform`, `_gumbel`, `categorical`.

A key is a `[..., 2]` int64 tensor holding two uint32 words; leading
dimensions batch keys (the engine's per-lane keys, where JAX `vmap`s).
Words are kept in int64 and masked to 32 bits after every addition and
shift: torch's uint32 covers few operations on CUDA, and int64 makes the
wrap-around and the logical right shift explicit. `log` is not
bit-identical across XLA's CPU code, torch's CPU and CUDA, so gumbel noise
agrees with JAX's to float32 rounding, not bit for bit; keys, bits and
uniforms are exact.

Nothing on a draw's path copies from host memory, so a CUDA graph can
capture it (the engine's decode window, `runtime/decode_server.py`): the
float constants of `uniform` enter as Python scalars (kernel arguments, no
copy), rounded to float32 on the host first, so the arithmetic is JAX's
float32 arithmetic. A draw keeps no state between calls. `fold_in` with a
Python int still builds its datum on the host; the engine folds tensors.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny
_F32_ONE_BITS = 0x3F800000  # 1.0f: exponent 0, mantissa filled from the bits

IntOrTensor = Union[int, torch.Tensor]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry_2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter pairs (x0, x1) under key (k0, k1):
    int64 tensors of uint32 words, broadcast together. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the key [0, seed mod 2^32] as int64 [2]."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _words(key: torch.Tensor):
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is a [..., 2] tensor, got shape {tuple(key.shape)}")
    key = key.to(torch.int64)
    return key[..., 0], key[..., 1]


def _counters(n: int, device):
    """The (hi, lo) words of the 64-bit iota 0..n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: key [..., 2] -> keys [..., num, 2]."""
    k0, k1 = _words(key)
    hi, lo = _counters(num, key.device)
    y0, y1 = threefry_2x32(k0[..., None], k1[..., None], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: IntOrTensor) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`, data taken mod 2^32. `data` may be
    a tensor broadcasting against the key's leading dimensions: a [N] data
    vector against one key [2] or keys [N, 2] gives keys [N, 2], which is
    the engine's `vmap` written out."""
    k0, k1 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & M32
    else:
        d = torch.tensor(int(data) & M32, dtype=torch.int64, device=key.device)
    y0, y1 = threefry_2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits, `jax.random.bits(key, shape, uint32)`, as int64
    in [0, 2^32): key [..., 2] -> [..., *shape], one draw per key row."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _words(key)
    n = math.prod(shape)
    hi, lo = _counters(n, key.device)
    y0, y1 = threefry_2x32(k0[..., None], k1[..., None], hi, lo)
    return (y0 ^ y1).reshape(*k0.shape, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32: the high 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled into [minval, maxval) and raised to
    at least minval. minval, maxval and their difference are float32
    values, as JAX's are; a float32 tensor times a Python float is float32
    arithmetic."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel` in float32, mode "low": -log(-log(u)), u
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis=-1)` with replacement:
    argmax(gumbel + logits) over the last axis, the first maximum on a tie.
    One key [2] draws its noise over the whole `logits` shape (JAX's single
    call); keys [N, 2] against logits [N, ..., V] draw each row's noise
    from its own key (JAX's `vmap` over rows). Returns int64 indices of
    shape logits.shape[:-1]."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical samples float32 logits, got {logits.dtype}")
    lead = key.dim() - 1
    if tuple(key.shape[:-1]) != tuple(logits.shape[:lead]):
        raise ValueError(
            f"keys {tuple(key.shape)} do not batch logits {tuple(logits.shape)}"
        )
    noise = gumbel(key, logits.shape[lead:])
    return torch.argmax(noise + logits, dim=-1)
