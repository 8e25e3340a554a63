"""The OOV bucket hash that the plain reference routes new ids with.

Frozen copy of `oovrec_tpu_torch/inductive/hashes.py` (`three_round_int_hash`
and `hash_ids` for the `3round` function) at commit f404fe0, itself a copy of
the reference recommender's `random_mapper.py:70-114`. It stays here so that a
change to the program's hash shows as a wrong bucket against this one.

Semantics: multiplication wraps modulo 2^64, `>>` is the arithmetic shift of
int64, and `%` is floor-mod, so a bucket is never negative.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64

HASH_FUNCTIONS = ("3round",)


def _const(c: int) -> np.int64:
    """A constant below 2^64 as the int64 with the same bits."""
    return _I64(np.uint64(c).astype(np.int64))


def three_round(x: np.ndarray) -> np.ndarray:
    """The 3-round integer hash (constants 0xed5ad4bb / 0xac4c1b51 /
    0x31848bab, shifts 17 / 11 / 15 / 14) in int64."""
    x = np.asarray(x, dtype=_I64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> 17)
        x = x * _const(0xED5AD4BB)
        x = x ^ (x >> 11)
        x = x * _const(0xAC4C1B51)
        x = x ^ (x >> 15)
        x = x * _const(0x31848BAB)
        x = x ^ (x >> 14)
    return x


def bucket_of(ids: np.ndarray, n_buckets: int, hash_function: str = "3round") -> np.ndarray:
    """hash(ids) % n_buckets, int64, in [0, n_buckets)."""
    if hash_function != "3round":
        raise ValueError(f"the reference holds the 3round hash only, not {hash_function!r}")
    return three_round(ids) % n_buckets


def eval_buckets(ids: np.ndarray, n_original: int, n_buckets: int,
                 hash_function: str = "3round") -> np.ndarray:
    """The bucket of a new id at evaluation: hash(id - n_original)."""
    return bucket_of(np.asarray(ids, _I64) - n_original, n_buckets, hash_function)


def simulated_buckets(ids: np.ndarray, n_original: int, n_buckets: int, prime_pad: int,
                      hash_function: str = "3round") -> np.ndarray:
    """The bucket of an id flagged new by the OOV simulation in training:
    hash(id + prime_pad - n_original)."""
    ext = np.asarray(ids, _I64) + _I64(prime_pad)
    return bucket_of(ext - n_original, n_buckets, hash_function)
