"""SipHash-2-4 for DHE hashing, on the host.

Copy of `oovrec_tpu/ops/siphash.py:59-188`: the vectorised numpy
SipHash-2-4 over a (B, K) grid of uint64 and the pure-Python scalar
version that tests hold it against. Messages are 8-byte little-endian ids
(the reference hashes `id.to_bytes(8, 'little')`, `dh_embedder.py:137,152`)
and keys 16 bytes. The JAX module's native library (`:28-56`) is left
out: its source lies in the JAX package, and the port builds only its own
sources. On the card, `ops/siphash_device.py` hashes where the batch lives.
"""

from __future__ import annotations

import numpy as np


def keys_to_u64(keys_bytes) -> np.ndarray:
    """List of 16-byte keys → (K, 2) uint64 little-endian halves."""
    out = np.empty((len(keys_bytes), 2), dtype=np.uint64)
    for i, k in enumerate(keys_bytes):
        out[i, 0] = int.from_bytes(k[:8], "little")
        out[i, 1] = int.from_bytes(k[8:], "little")
    return out


def siphash24_batch(msgs: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """(B,) uint64 msgs × (K, 2) uint64 keys → (B, K) uint64 digests."""
    msgs = np.ascontiguousarray(msgs, dtype=np.uint64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    return _siphash24_numpy(msgs, keys)


def _siphash24_numpy(msgs: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Vectorized over the full (B, K) grid in uint64."""
    u64 = np.uint64

    def rotl(x, b):
        return (x << u64(b)) | (x >> u64(64 - b))

    k0 = keys[:, 0][None, :]
    k1 = keys[:, 1][None, :]
    m = msgs[:, None]
    with np.errstate(over="ignore"):
        v0 = u64(0x736F6D6570736575) ^ k0
        v1 = u64(0x646F72616E646F6D) ^ k1
        v2 = u64(0x6C7967656E657261) ^ k0
        v3 = u64(0x7465646279746573) ^ k1
        v0 = np.broadcast_to(v0, (len(msgs), len(keys))).copy()
        v1 = np.broadcast_to(v1, v0.shape).copy()
        v2 = np.broadcast_to(v2, v0.shape).copy()
        v3 = np.broadcast_to(v3, v0.shape).copy()

        def sipround(v0, v1, v2, v3):
            v0 += v1
            v1 = rotl(v1, 13)
            v1 ^= v0
            v0 = rotl(v0, 32)
            v2 += v3
            v3 = rotl(v3, 16)
            v3 ^= v2
            v0 += v3
            v3 = rotl(v3, 21)
            v3 ^= v0
            v2 += v1
            v1 = rotl(v1, 17)
            v1 ^= v2
            v2 = rotl(v2, 32)
            return v0, v1, v2, v3

        v3 ^= m
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0 ^= m
        b = u64(8 << 56)
        v3 ^= b
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0 ^= b
        v2 ^= u64(0xFF)
        for _ in range(4):
            v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        return v0 ^ v1 ^ v2 ^ v3


def siphash24_py(key: bytes, msg: bytes) -> bytes:
    """Scalar pure-python SipHash-2-4 (test oracle; full message support)."""
    MASK = (1 << 64) - 1

    def rotl(x, b):
        return ((x << b) | (x >> (64 - b))) & MASK

    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def sipround():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & MASK
        v1 = rotl(v1, 13)
        v1 ^= v0
        v0 = rotl(v0, 32)
        v2 = (v2 + v3) & MASK
        v3 = rotl(v3, 16)
        v3 ^= v2
        v0 = (v0 + v3) & MASK
        v3 = rotl(v3, 21)
        v3 ^= v0
        v2 = (v2 + v1) & MASK
        v1 = rotl(v1, 17)
        v1 ^= v2
        v2 = rotl(v2, 32)

    b = len(msg)
    full = b // 8
    for i in range(full):
        mi = int.from_bytes(msg[8 * i : 8 * i + 8], "little")
        v3 ^= mi
        sipround()
        sipround()
        v0 ^= mi
    last = (b & 0xFF) << 56
    tail = msg[8 * full :]
    for i, ch in enumerate(tail):
        last |= ch << (8 * i)
    v3 ^= last
    sipround()
    sipround()
    v0 ^= last
    v2 ^= 0xFF
    for _ in range(4):
        sipround()
    return ((v0 ^ v1 ^ v2 ^ v3) & MASK).to_bytes(8, "little")
