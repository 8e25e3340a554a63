"""BPR over pairwise interactions (`BPR.yaml`)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import generate
from benchmark.harness.models import inductive_spec, spec_of
from benchmark.reference import bpr as ref_bpr


class Adapter:
    dropout = False
    # the id columns the OOV simulation masks in every path of the program
    masked_columns = ("user_id", "item_id")

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.corpus = cfg["corpus"]

    def build(self, device):
        from oovrec_tpu_torch.models.bpr import BPR

        c = self.corpus
        return BPR(c["n_old_users"], c["n_old_items"], self.cfg["model_args"]["embedding_size"],
                   inductive_spec(self.cfg), device=device)

    def train_loader(self, seed: int, port_cfg, mix: dict):
        from oovrec_tpu_torch.data.dataloader import TrainBatcher
        from oovrec_tpu_torch.data.dataset import DatasetSplit
        from oovrec_tpu_torch.data.sampler import Sampler
        from oovrec_tpu_torch.utils.enums import InputType

        users, items = generate.interactions(self.corpus, seed)
        # each user's training items, as sorted keys, for the negatives' check
        self.used = np.unique(users * np.int64(self.corpus["n_old_items"]) + items)
        split = DatasetSplit({"user_id": users, "item_id": items},
                             self.corpus["n_old_users"], self.corpus["n_old_items"])
        sampler = Sampler(["train"], [split], seed=seed)
        return TrainBatcher(split, sampler, port_cfg, InputType.PAIRWISE)

    def reference_loss(self):
        return ref_bpr.loss, {"spec": spec_of(self.cfg)}

    def reference_batch(self, batch: dict, stage: str) -> dict:
        return batch

    def checks(self, stages: Dict[str, dict]) -> Dict[str, float]:
        """`neg_used`: the share of the recorded weighted rows (both stages)
        whose negative is among the user's training items; rows whose user
        or negative the simulation masked are left out."""
        n_items = np.int64(self.corpus["n_old_items"])
        hit = seen = 0
        for st in stages.values():
            for b in st["batches"]:
                u = b["user_id"].long().cpu().numpy()
                neg = b["neg_item_id"].long().cpu().numpy()
                ok = (b["weight"].cpu().numpy() > 0) & (u > 0) & (neg > 0)
                keys = u[ok] * n_items + neg[ok]
                at = np.minimum(np.searchsorted(self.used, keys), len(self.used) - 1)
                hit += int((self.used[at] == keys).sum())
                seen += int(ok.sum())
        return {"neg_used": hit / max(seen, 1)}

    def unchecked_negatives(self, batches: List[dict], seed: int) -> List[dict]:
        """The fault of negatives drawn without the used-pair check: each
        row's negative a uniform draw over the old items."""
        g = np.random.default_rng(int(seed) + 13)
        out = []
        for b in batches:
            neg = g.integers(1, self.corpus["n_old_items"], b["neg_item_id"].shape[0])
            out.append(dict(b, neg_item_id=torch.from_numpy(neg).to(b["neg_item_id"].device)))
        return out

    def gathers(self, batch: dict) -> List[tuple]:
        """The program's row gathers of one training step, (ids, live,
        rows, width), each one backward call: the user, the item and the
        negative column, each through its table and its bucket table."""
        c, p, d = self.corpus, self.cfg["port"], self.cfg["model_args"]["embedding_size"]
        out = []
        for field, side, flagged in (("user_id", "user", True), ("item_id", "item", True),
                                     ("neg_item_id", "item", False)):
            ids = batch[field]
            f = batch.get(field + "_oov") if flagged else None
            n_rows = c[f"n_old_{side}s"]
            new = (ids >= n_rows) if f is None else ((ids >= n_rows) | (f > 0))
            out.append((ids, ~new, n_rows, d))
            out.append((batch.get(field + "_bucket", torch.zeros_like(ids)), new,
                        p[f"n_{side}_oov_buckets"], d))
        return out
