"""Host-side inductive ID mapper.

Equivalent of `RandomOOVInductiveMapper` (`recbole/inductive/
random_mapper.py:37-131`), re-shaped for the static-shape pipeline: instead
of remapping IDs inside the model forward, the mapper annotates batches on
the host with `(<side>_oov, <side>_bucket)` columns; the device routing
then selects IV table rows or OOV bucket rows branchlessly.

Semantics preserved:
  * IDs < n_original pass through (IV).
  * OOV IDs hash as `hash(id_ext - n_original) % n_buckets` where `id_ext`
    is the raw inductive ID at eval time, or `orig_id + prime_pad` for
    OOV-simulated training rows (`random_mapper.py:116-130` +
    `trainer.py:1748-1759`).
  * train mode advertises a doubled ID space (`set_train`,
    `random_mapper.py:48-51`).
"""

from __future__ import annotations

import numpy as np

from oovrec_tpu_torch.inductive.hashes import hash_ids
from oovrec_tpu_torch.inductive.spec import InductiveSpec


class RandomOOVMapper:
    def __init__(
        self,
        spec: InductiveSpec,
        n_original_users: int,
        n_original_items: int,
        n_new_users: int = None,
        n_new_items: int = None,
    ):
        self.spec = spec
        self.n_original_users = n_original_users
        self.n_original_items = n_original_items
        self._n_inductive_users = n_new_users or n_original_users
        self._n_inductive_items = n_new_items or n_original_items
        self.training = False

    def set_train(self) -> None:
        self.training = True
        self.n_new_users = self.n_original_users * 2
        self.n_new_items = self.n_original_items * 2

    def set_eval(self) -> None:
        self.training = False
        self.n_new_users = self._n_inductive_users
        self.n_new_items = self._n_inductive_items

    # -- bucket computation (host, int64) ---------------------------------

    def user_buckets(self, ext_ids: np.ndarray) -> np.ndarray:
        """hash(ext_id - n_original) % n_user_buckets for OOV ext ids."""
        return hash_ids(
            np.asarray(ext_ids, np.int64) - self.n_original_users,
            self.spec.n_user_buckets,
            self.spec.hash_function,
        )

    def item_buckets(self, ext_ids: np.ndarray) -> np.ndarray:
        return hash_ids(
            np.asarray(ext_ids, np.int64) - self.n_original_items,
            self.spec.n_item_buckets,
            self.spec.hash_function,
        )

    def map_user_ids(self, ids: np.ndarray) -> np.ndarray:
        """Classic mapped-ID view (for parity checks/tests):
        IV ids pass through, OOV ids → n_original + bucket."""
        ids = np.asarray(ids, np.int64)
        oov = ids >= self.n_original_users
        out = ids.copy()
        out[oov] = self.n_original_users + self.user_buckets(ids[oov])
        return out

    def map_item_ids(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        oov = ids >= self.n_original_items
        out = ids.copy()
        out[oov] = self.n_original_items + self.item_buckets(ids[oov])
        return out

    # -- batch annotation --------------------------------------------------

    def annotate(self, batch: dict, uid_field: str, iid_field: str,
                 neg_prefix: str = "neg_") -> dict:
        """Add `<side>_oov` / `<side>_bucket` columns for raw eval IDs.

        Raw IDs stay in place (they index feature matrices); IDs ≥
        n_original are flagged OOV with their hashed bucket. OOV-simulated
        training rows are annotated by `transform.simulate_oov` instead.
        """
        for field, n_orig, fn in (
            (uid_field, self.n_original_users, self.user_buckets),
            (iid_field, self.n_original_items, self.item_buckets),
            (neg_prefix + iid_field, self.n_original_items, self.item_buckets),
        ):
            if field not in batch:
                continue
            ids = np.asarray(batch[field], np.int64)
            oov = (ids >= n_orig).astype(np.int32)
            buckets = np.zeros_like(ids)
            if oov.any():
                buckets = np.where(oov, fn(ids), 0)
            batch[field + "_oov"] = oov
            batch[field + "_bucket"] = buckets.astype(np.int64)
        return batch
