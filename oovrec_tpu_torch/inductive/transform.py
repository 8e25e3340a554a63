"""OOV-simulation batch transform (training regime).

A copy of `oovrec_tpu/inductive/transform.py:26-104` with its imports
rewritten: numpy only, bit-exact with the JAX package's on the same
`np.random.Generator` stream (the trainer's `host_rng(seed, "oov_regime")`).

Equivalent of `InductiveTrainer._transform_interaction_oov`
(`recbole/trainer/trainer.py:1748-1759`): pick uniformly one of
{pad items, pad users, pad both}, then independently zero-mask every column
entry with `oov_feature_mask_rate`.

Static-shape re-design: instead of literally adding `oov_prime_pad` to the
ID columns (which forces int64 onto the device), the transform keeps raw
IDs and sets `<side>_oov` flags plus the host-hashed `<side>_bucket` the
padded ID would map to (hash input `orig_id + prime_pad - n_original` —
bit-identical to the reference's `map_*_ids` on padded IDs). Zero-masking
an ID column clears its flag: in the reference a zeroed padded ID becomes
the IV PAD id 0 (`0 < n_users`), which is exactly raw id 0 with no flag.
"""

from __future__ import annotations

import numpy as np

from oovrec_tpu_torch.inductive.hashes import hash_ids
from oovrec_tpu_torch.inductive.spec import InductiveSpec


class OOVSimulator:
    def __init__(
        self,
        spec: InductiveSpec,
        n_original_users: int,
        n_original_items: int,
        feature_mask_rate: float,
        rng: np.random.Generator,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        label_field: str = "label",
    ):
        self.spec = spec
        self.n_users = n_original_users
        self.n_items = n_original_items
        self.mask_rate = feature_mask_rate
        self.rng = rng
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.label_field = label_field

    def _sim_buckets(self, ids: np.ndarray, n_original: int, n_buckets: int):
        """Bucket of `id + prime_pad` under the mapper's hash."""
        ext = np.asarray(ids, np.int64) + self.spec.prime_pad
        return hash_ids(ext - n_original, n_buckets, self.spec.hash_function)

    def __call__(self, batch: dict) -> dict:
        """Transform a batch in place; returns it for chaining.

        Columns ending in `weight` and routing annotations are never masked
        (they are pipeline metadata, not interaction fields).
        """
        out = dict(batch)
        option = int(self.rng.integers(0, 3))
        pad_items = option in (0, 2)
        pad_users = option in (1, 2)

        data_cols = [
            k
            for k in out
            if not k.endswith("weight")
            and not k.endswith("_oov")
            and not k.endswith("_bucket")
            and k not in ("row_user", "positive_u", "positive_i", "n_users")
        ]

        n = len(out[self.uid_field])
        if pad_users:
            out[self.uid_field + "_oov"] = np.ones(n, dtype=np.int32)
            if self.spec.n_user_buckets:
                out[self.uid_field + "_bucket"] = self._sim_buckets(
                    out[self.uid_field], self.n_users, self.spec.n_user_buckets
                )
        if pad_items:
            out[self.iid_field + "_oov"] = np.ones(n, dtype=np.int32)
            if self.spec.n_item_buckets:
                out[self.iid_field + "_bucket"] = self._sim_buckets(
                    out[self.iid_field], self.n_items, self.spec.n_item_buckets
                )

        if self.mask_rate > 0:
            for col in data_cols:
                v = out[col]
                if not isinstance(v, np.ndarray) or v.ndim == 0:
                    continue
                mask = self.rng.random(v.shape) < self.mask_rate
                v = v.copy()
                v[mask] = 0
                out[col] = v
                # a zeroed (previously padded) ID collapses to IV PAD id 0
                if col == self.uid_field and pad_users:
                    flag = out[col + "_oov"].copy()
                    flag[mask] = 0
                    out[col + "_oov"] = flag
                if col == self.iid_field and pad_items:
                    flag = out[col + "_oov"].copy()
                    flag[mask] = 0
                    out[col + "_oov"] = flag
        return out
