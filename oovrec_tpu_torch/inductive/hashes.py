"""Integer ID-hash functions for OOV bucket routing.

Bit-exact NumPy int64 re-implementations of the reference's hash family
(`recbole/inductive/random_mapper.py:70-114`):

  * ``fast``   — 2-round lowbias32-style xorshift/multiply
                 (constants 0x21f0aaad / 0xd35a2d97, shifts 16/15/15)
  * ``3round`` — 3-round integer hash
                 (constants 0xed5ad4bb / 0xac4c1b51 / 0x31848bab,
                  shifts 17/11/15/14) — the default
  * ``64bit``  — splitmix64 finalizer in uint64
  * ``mod``    — plain modulo

Semantics that matter for parity with torch int64 tensors:
  - multiplications wrap modulo 2^64 (two's complement),
  - ``>>`` is an *arithmetic* shift (sign-extending) on int64,
  - ``%`` follows Python floor-mod (result sign follows the divisor), so
    bucket indices are always non-negative.

These run on the host as part of the input pipeline: hashing a batch of IDs
is O(batch) integer ops, so the device only ever sees the resulting bucket
column. Copied from `oovrec_tpu/inductive/hashes.py` so the port imports
nothing of the JAX package; the two must stay bit-identical.
"""

from __future__ import annotations

import numpy as np

HASH_FUNCTIONS = ("mod", "fast", "3round", "64bit")

_U64 = np.uint64
_I64 = np.int64


def fast_int_hash(x: np.ndarray) -> np.ndarray:
    """2-round integer hash, int64 wraparound semantics."""
    x = np.asarray(x, dtype=_I64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> 16)
        x = x * _I64_const(0x21F0AAAD)
        x = x ^ (x >> 15)
        x = x * _I64_const(0xD35A2D97)
        x = x ^ (x >> 15)
    return x


def three_round_int_hash(x: np.ndarray) -> np.ndarray:
    """3-round integer hash, int64 wraparound semantics (the default)."""
    x = np.asarray(x, dtype=_I64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> 17)
        x = x * _I64_const(0xED5AD4BB)
        x = x ^ (x >> 11)
        x = x * _I64_const(0xAC4C1B51)
        x = x ^ (x >> 15)
        x = x * _I64_const(0x31848BAB)
        x = x ^ (x >> 14)
    return x


def big_64bit_hash(x: np.ndarray, n_buckets: int) -> np.ndarray:
    """splitmix64-style finalizer computed in uint64, already bucketed.

    Quirk preserved: the reference builds its multipliers with
    `int.from_bytes(b'\xbf\x58...', byteorder='little')`
    (`random_mapper.py:98-100`), i.e. the BYTE-SWAPPED standard splitmix64
    constants — 0xB9E5E41C6D4758BF / 0xEB113113BB49D094. Bit-compatibility
    (same ids → same buckets → reusable checkpoints) requires using the
    swapped values, verified against the reference class directly in
    tests/test_reference_parity.py."""
    x = np.asarray(x, dtype=_I64).astype(_U64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> _U64(30))) * _U64(0xB9E5E41C6D4758BF)
        x = (x ^ (x >> _U64(27))) * _U64(0xEB113113BB49D094)
        x = x ^ (x >> _U64(31))
        x = x % _U64(n_buckets)
    return x.astype(_I64)


def hash_ids(ids: np.ndarray, n_buckets: int, hash_function: str) -> np.ndarray:
    """Hash (possibly huge, prime-padded) IDs into ``[0, n_buckets)``.

    Equivalent of `random_mapper.py:104-114` — result dtype int64, always
    non-negative (floor-mod semantics).
    """
    ids = np.asarray(ids, dtype=_I64)
    if hash_function == "mod":
        return ids % n_buckets
    if hash_function == "fast":
        return fast_int_hash(ids) % n_buckets
    if hash_function == "3round":
        return three_round_int_hash(ids) % n_buckets
    if hash_function == "64bit":
        return big_64bit_hash(ids, n_buckets)
    raise ValueError(f"Unknown hash function {hash_function!r}")


def _I64_const(c: int) -> np.int64:
    """Interpret a (possibly >2^63) constant as a two's-complement int64."""
    return _I64(np.uint64(c).astype(np.int64))
