"""OOV bucket hashing on the device, in native int64.

Port of `oovrec_tpu/ops/inthash_device.py:125-147`. The device-resident
OOV sub-epoch (`train/device_epoch.py`) hashes the simulated padded ids
where the batch lives. The JAX module emulates int64 on uint32 pairs
because TPUs have no int64; torch tensors do, so the hash family of
`inductive/hashes.py` is written directly, bit-exact with it:

  * multiplication wraps modulo 2^64 (two's complement);
  * `>>` on int64 is arithmetic, which '3round', 'fast' and 'mod' want;
    '64bit' is uint64 arithmetic, so its shifts are logical (masked after
    the shift) and its constants above 2^63 are written as signed int64;
  * `%` of int64 tensors is floor-mod (non-negative for a positive
    divisor); the unsigned mod of '64bit' is derived from the signed value.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.inductive.hashes import HASH_FUNCTIONS


def _i64(c: int) -> int:
    """A 64-bit constant as the signed int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def _xor_shr(x: torch.Tensor, k: int) -> torch.Tensor:
    return x ^ (x >> k)


def _xor_lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ^ (x >>> k), the logical shift of the uint64 bits."""
    return x ^ ((x >> k) & ((1 << (64 - k)) - 1))


def three_round(x: torch.Tensor) -> torch.Tensor:
    """`three_round_int_hash` (hashes.py:48-59), int64 semantics."""
    x = _xor_shr(x, 17) * 0xED5AD4BB
    x = _xor_shr(x, 11) * 0xAC4C1B51
    x = _xor_shr(x, 15) * 0x31848BAB
    return _xor_shr(x, 14)


def fast(x: torch.Tensor) -> torch.Tensor:
    """`fast_int_hash` (hashes.py:36-45), int64 semantics."""
    x = _xor_shr(x, 16) * 0x21F0AAAD
    x = _xor_shr(x, 15) * 0xD35A2D97
    return _xor_shr(x, 15)


def splitmix_swapped(x: torch.Tensor) -> torch.Tensor:
    """`big_64bit_hash`'s core (hashes.py:62-78) before the mod: uint64,
    logical shifts, the byte-swapped splitmix constants."""
    x = _xor_lshr(x, 30) * _i64(0xB9E5E41C6D4758BF)
    x = _xor_lshr(x, 27) * _i64(0xEB113113BB49D094)
    return _xor_lshr(x, 31)


def _umod(x: torch.Tensor, b: int) -> torch.Tensor:
    """The uint64 value of x's bits mod b: a negative x stands for x + 2^64."""
    r = x % b
    return torch.where(x < 0, (r + (1 << 64) % b) % b, r)


def sim_buckets_device(ids: torch.Tensor, n_original: int, n_buckets: int,
                       hash_function: str, prime_pad: int) -> torch.Tensor:
    """Bucket of `id + prime_pad` under the mapper's hash, the device twin of
    `OOVSimulator._sim_buckets` (inductive/transform.py):
    hash((id + prime_pad) - n_original) % n_buckets, as int64."""
    if hash_function not in HASH_FUNCTIONS:
        raise NotImplementedError(hash_function)
    x = ids.long() + (prime_pad - n_original)
    if hash_function == "mod":
        return x % n_buckets
    if hash_function == "3round":
        return three_round(x) % n_buckets
    if hash_function == "fast":
        return fast(x) % n_buckets
    return _umod(splitmix_swapped(x), n_buckets)
