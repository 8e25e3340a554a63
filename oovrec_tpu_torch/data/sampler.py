"""Negative sampling.

Equivalent of `recbole/sampler/sampler.py:147-490`, re-designed for the
static-shape pipeline: sampling runs vectorized on the host (NumPy) with
bounded-round masked resampling instead of unbounded per-row rejection
loops, and emits fixed-shape int arrays for the device.

Phase semantics preserved: per-phase *cumulative* used-ID sets
(train ⊂ valid ⊂ test, `sampler.py:238-263`) so negatives for phase P are
guaranteed uninteracted in P and all earlier phases; uniform negatives are
drawn from [1, item_num) (PAD=0 excluded, `sampler.py:235`); popularity
sampling draws proportional to interaction counts (`sampler.py:99`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from oovrec_tpu_torch.utils.seeding import host_rng

_MAX_RESAMPLE_ROUNDS = 64


class Sampler:
    """Cross-phase negative sampler over [train, valid, test] splits."""

    def __init__(
        self,
        phases: Sequence[str],
        splits: Sequence,  # DatasetSplit per phase
        distribution: str = "uniform",
        alpha: float = 1.0,
        seed: int = 2020,
        repeatable: bool = False,
    ):
        if len(phases) != len(splits):
            raise ValueError("phases and splits must align")
        self.phases = list(phases)
        self.distribution = distribution
        self.alpha = alpha
        self.repeatable = repeatable
        self.user_num = splits[0].user_num
        self.item_num = splits[0].item_num
        self.rng = host_rng(seed, "negative_sampler")

        # cumulative per-user used item sets, one snapshot per phase
        self.used_ids: Dict[str, List[np.ndarray]] = {}
        last: List[np.ndarray] = [
            np.array([], dtype=np.int64) for _ in range(self.user_num)
        ]
        for phase, split in zip(self.phases, splits):
            cur = list(last)
            per_user = split.used_ids_per_user()
            for u in range(self.user_num):
                if len(per_user[u]):
                    cur[u] = np.union1d(cur[u], per_user[u])
            self.used_ids[phase] = cur
            last = cur
        # vectorized membership: per phase, one sorted array of composite
        # keys user*item_num + item — membership is a single searchsorted.
        self._keys: Dict[str, np.ndarray] = {}
        for phase, per_user in self.used_ids.items():
            parts = [
                u * self.item_num + items
                for u, items in enumerate(per_user)
                if len(items)
            ]
            keys = (
                np.sort(np.concatenate(parts))
                if parts
                else np.array([], dtype=np.int64)
            )
            self._keys[phase] = keys

        # popularity weights (train interactions)
        if distribution == "popularity":
            counts = np.zeros(self.item_num, dtype=np.float64)
            iid = splits[0].inter[splits[0].iid_field]
            np.add.at(counts, iid, 1.0)
            counts = counts**alpha
            counts[0] = 0.0
            self._pop_p = counts / counts.sum()
        else:
            self._pop_p = None

    def _draw(self, n: int, rng=None) -> np.ndarray:
        rng = rng if rng is not None else self.rng
        if self.distribution == "uniform":
            return rng.integers(1, self.item_num, size=n, dtype=np.int64)
        if self.distribution == "popularity":
            return rng.choice(self.item_num, size=n, p=self._pop_p)
        raise NotImplementedError(
            f"The distribution [{self.distribution}] has not been implemented."
        )

    # packed membership bitmap threshold: user_num × item_num / 8 bytes.
    # Under it, _is_used is an O(1) vectorized bit test instead of a
    # binary search — the search was the TrainBatcher's top cost (440 ns
    # per probe over ~1M keys; the bit test is ~10 ns)
    _BITMAP_BYTES_CAP = 256 * 1024 * 1024

    def _used_bitmap(self, phase: str):
        bm = getattr(self, "_bitmaps", None)
        if bm is None:
            bm = self._bitmaps = {}
        if phase not in bm:
            W = -(-self.item_num // 32)
            if self.user_num * W * 4 > self._BITMAP_BYTES_CAP:
                bm[phase] = None
            else:
                keys = self._keys[phase]
                u = keys // self.item_num
                it = keys % self.item_num
                m = np.zeros(self.user_num * W, np.uint32)
                np.bitwise_or.at(
                    m, u * W + (it >> 5),
                    np.uint32(1) << (it & 31).astype(np.uint32),
                )
                bm[phase] = m.reshape(self.user_num, W)
        return bm[phase]

    def _is_used(self, phase: str, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        keys = self._keys[phase]
        if keys.size == 0:
            return np.zeros(len(users), dtype=bool)
        bm = self._used_bitmap(phase)
        if bm is not None:
            w = bm[users, items >> 5]
            return ((w >> (items & 31).astype(np.uint32)) & 1).astype(bool)
        q = users * self.item_num + items
        pos = np.searchsorted(keys, q)
        pos = np.minimum(pos, len(keys) - 1)
        return keys[pos] == q

    def sample_negatives(
        self, phase: str, users: np.ndarray, num: int, rng=None
    ) -> np.ndarray:
        """Sample `num` negatives per user row → (len(users), num) int64.

        Repeatable mode (`RepeatableSampler`, `sampler.py:371`) skips the
        used-ID avoidance entirely — any item can be a negative.

        `rng` substitutes a caller-owned stream for the sampler's shared
        cumulative one — eval batchers pass a per-pass stream so eval
        candidates don't depend on how many training draws preceded them
        (order-independent reproducibility; checkpoint reloads re-derive
        identical uniN candidate sets).
        """
        users = np.asarray(users, dtype=np.int64)
        total = len(users) * num
        rep_users = np.repeat(users, num)
        neg = self._draw(total, rng)
        if not self.repeatable:
            for _ in range(_MAX_RESAMPLE_ROUNDS):
                bad = self._is_used(phase, rep_users, neg)
                n_bad = int(bad.sum())
                if n_bad == 0:
                    break
                neg[bad] = self._draw(n_bad, rng)
        return neg.reshape(len(users), num)


class KGSampler:
    """Negative tail-entity sampler for knowledge models (`sampler.py:304`)."""

    def __init__(self, kg_heads, kg_tails, entity_num: int, seed: int = 2020):
        self.entity_num = entity_num
        self.rng = host_rng(seed, "kg_sampler")
        self.used: Dict[int, set] = {}
        for h, t in zip(kg_heads, kg_tails):
            self.used.setdefault(int(h), set()).add(int(t))

    def sample_negatives(self, heads: np.ndarray, num: int = 1) -> np.ndarray:
        heads = np.asarray(heads, dtype=np.int64)
        out = np.empty((len(heads), num), dtype=np.int64)
        for i, h in enumerate(heads):
            used = self.used.get(int(h), set())
            for j in range(num):
                t = int(self.rng.integers(1, self.entity_num))
                for _ in range(_MAX_RESAMPLE_ROUNDS):
                    if t not in used:
                        break
                    t = int(self.rng.integers(1, self.entity_num))
                out[i, j] = t
        return out
