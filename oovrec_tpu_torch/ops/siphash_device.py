"""SipHash-2-4 for DHE where the batch lives, in native int64.

Port of `oovrec_tpu/ops/siphash_device.py:88-125` (`dhe_codes_device`).
The JAX module emulates each 64-bit lane as a uint32 (lo, hi) pair because
TPUs have no int64; torch tensors do, so the rounds are written on int64
holding the uint64 bits:

  * addition wraps modulo 2^64, as uint64 addition does;
  * `<<` keeps the low 64 bits; `>>` on int64 is arithmetic, so the right
    half of each rotation is masked after the shift, which makes it the
    logical shift of the uint64 bits;
  * the keys (K, 2) are the uint64 halves of `inductive/dhe.py` as int64
    bit patterns, and an id is its int64 value (a negative id hashes the
    8 bytes of its two's complement, as `astype(np.uint64)` gives them).

Bit-exact with `ops/siphash.py:siphash24_batch(...) % 2**24`.
"""

from __future__ import annotations

import torch

MAX_HASH = 16_777_216  # 2^24, `dh_embedder.py:53`


def _i64(c: int) -> int:
    """A 64-bit constant as the signed int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def _rotl(x: torch.Tensor, b: int) -> torch.Tensor:
    return (x << b) | ((x >> (64 - b)) & ((1 << b) - 1))


def _sipround(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = v2 + v3
    v3 = _rotl(v3, 16) ^ v2
    v0 = v0 + v3
    v3 = _rotl(v3, 21) ^ v0
    v2 = v2 + v1
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash24_i64(msgs: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(B,) int64 ids × (K, 2) int64 keys → (B, K) int64 digests (the
    uint64 bits): SipHash-2-4 of each id's 8 little-endian bytes."""
    m = msgs.long()[:, None]
    k0, k1 = keys[:, 0].long()[None, :], keys[:, 1].long()[None, :]
    shape = (m.shape[0], k0.shape[1])
    v0 = (k0 ^ _i64(0x736F6D6570736575)).expand(shape)
    v1 = (k1 ^ _i64(0x646F72616E646F6D)).expand(shape)
    v2 = (k0 ^ _i64(0x6C7967656E657261)).expand(shape)
    v3 = (k1 ^ _i64(0x7465646279746573)) ^ m
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 = v0 ^ m
    b = 8 << 56  # the message length in the top byte
    v3 = v3 ^ b
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 = v0 ^ b
    v2 = v2 ^ 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def dhe_codes_device(ids: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(B,) int64 ids → (B, K) float32 of digests % 2^24, the DHE input,
    computed on the ids' device."""
    return (siphash24_i64(ids, keys) & (MAX_HASH - 1)).float()
