"""DHE hashing: ID → num_hashes SipHash-2-4 digests mod 2^24.

Port of `oovrec_tpu/inductive/dhe.py` (`DHEHasher`): the reference hashes
the (possibly prime-padded) id's 8 little-endian bytes with `num_hashes`
persisted SipHash keys, memoised per id (`dh_embedder.py:122-170`,
`feat_dh_embedder.py:133-197`). Here a batch hashes in one numpy call
(`ops/siphash.py`), each distinct id once, and a dict memoises rows
across batches.

Key files keep the reference's format (`get_hash_keys`,
`dh_embedder.py:95-120`): `<hash_key_dir>/<num_hashes>.hashes`, a JSON
list of hex-encoded 16-byte keys. A file written by the JAX package or the
reference is read here, and the other way round. Without a file the keys
are drawn at random and written there.

With `on_device`, `annotate_batch` ships the effective id itself as one
int64 column `<field>_dhe_id` and the model hashes it on the card
(`ops/siphash_device.py`); the JAX package's `_dhe_lo` / `_dhe_hi` uint32
split is a TPU workaround.
"""

from __future__ import annotations

import json
import os
import secrets
from typing import Dict, Optional

import numpy as np

from oovrec_tpu_torch.ops.siphash import keys_to_u64, siphash24_batch

MAX_HASH = 16777216  # 2^24 (`dh_embedder.py:53`)


class DHEHasher:
    def __init__(self, num_hashes: int = 128,
                 hash_key_dir: str = "./hash_keys",
                 keys_u64: Optional[np.ndarray] = None,
                 on_device: bool = False):
        self.num_hashes = num_hashes
        self.hash_key_dir = hash_key_dir
        self.on_device = on_device
        if keys_u64 is not None:
            self.keys = np.asarray(keys_u64, dtype=np.uint64).reshape(-1, 2)
            assert len(self.keys) == num_hashes
        else:
            self.keys = self._load_or_create_keys()
        self._memo: Dict[int, np.ndarray] = {}

    def _load_or_create_keys(self) -> np.ndarray:
        os.makedirs(self.hash_key_dir, exist_ok=True)
        path = os.path.join(self.hash_key_dir, f"{self.num_hashes}.hashes")
        if os.path.exists(path):
            with open(path) as f:
                hexes = json.load(f)
            assert len(hexes) == self.num_hashes
            return keys_to_u64([bytes.fromhex(x) for x in hexes])
        key_bytes = [secrets.token_bytes(16) for _ in range(self.num_hashes)]
        with open(path, "w") as f:
            json.dump([k.hex() for k in key_bytes], f)
        return keys_to_u64(key_bytes)

    def hash_ids(self, ids: np.ndarray) -> np.ndarray:
        """(B,) int → (B, num_hashes) float32 of digests % 2^24."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((len(ids), self.num_hashes), dtype=np.float32)
        miss_idx = []
        miss_ids = []
        for i, v in enumerate(ids):
            row = self._memo.get(int(v))
            if row is None:
                miss_idx.append(i)
                miss_ids.append(int(v))
            else:
                out[i] = row
        if miss_ids:
            # each distinct missing id hashed once (the JAX hasher hashes
            # every missing position); the rows are the same
            uniq, inv = np.unique(np.array(miss_ids, dtype=np.int64), return_inverse=True)
            digests = siphash24_batch(uniq.astype(np.uint64), self.keys)
            rows = (digests % np.uint64(MAX_HASH)).astype(np.float32)
            for v, row in zip(uniq.tolist(), rows):
                self._memo[v] = row
            out[np.asarray(miss_idx)] = rows[inv.reshape(-1)]
        return out

    def annotate_batch(self, batch: dict, field: str, prime_pad: int,
                       padded_when_flagged: bool = True) -> dict:
        """Attach the hashes of the effective id: `<field>_dhe`, or the id
        column `<field>_dhe_id` when hashing on the card.

        Reference semantics: DHE/fDHE hash the PADDED id during OOV
        simulation (`feat_dh_embedder.py:190-197` hashes `old_user_ids`),
        while feature lookups use the unpadded id (routing indexes the
        feature matrices with the raw id column)."""
        ids = np.asarray(batch[field], dtype=np.int64)
        flags = np.asarray(batch.get(field + "_oov", np.zeros_like(ids)))
        if padded_when_flagged:
            eff = np.where(flags > 0, ids + prime_pad, ids)
        else:
            eff = ids
        if self.on_device:
            batch[field + "_dhe_id"] = eff
        else:
            batch[field + "_dhe"] = self.hash_ids(eff)
        return batch


def model_hasher(model, config) -> Optional[DHEHasher]:
    """The DHE / fDHE hasher over the keys in `model`'s embedder state
    (`trainer.py:150-167`, `eval/inductive.py:60-85` of the JAX package),
    hashing on the card under `dhe_on_device`; None for other embedders."""
    spec = getattr(model, "spec", None)
    if spec is None or spec.embedder not in ("dhe", "fdhe"):
        return None
    keys = model.embedder_state["dhe_keys"].cpu().numpy().view(np.uint64)
    return DHEHasher(spec.dhe_num_hashes, config.get("hash_key_dir") or "./hash_keys",
                     keys_u64=keys, on_device=bool(config["dhe_on_device"]))
