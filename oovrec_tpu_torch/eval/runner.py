"""Evaluation runner: loader → device step → collector → metrics.

Port of `oovrec_tpu/eval/runner.py:24-148, 410-564` on two paths:
  * full sort (retrieval models): the dense step (`mask_and_topk` over
    `full_sort_scores`) and the fused step
    (`ops/topk_score.py:fused_topk_scores` over the two towers);
  * value (ranking models): `PlainEvalBatcher` rows → `model.predict` →
    pooled (score, label) pairs → AUC / LogLoss / RMSE / MAE.
The scanned, sampled-negative and multi-device paths come with later
slices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from oovrec_tpu_torch.data.dataloader import FullSortEvalBatcher, PlainEvalBatcher
from oovrec_tpu_torch.eval.collector import (
    Collector,
    Evaluator,
    meanrank_from_scores,
)
from oovrec_tpu_torch.eval.full_sort import apply_masks, mask_and_topk


def to_device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch → device tensors (integers as int64, floats as f32)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype.kind in "iu":
            v = v.astype(np.int64)
        elif v.dtype == np.float64:
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(v).to(device)
    return out


def fused_topk_rule(flag, device_type: str, two_tower: bool, n_items: int) -> bool:
    """Whether a full-sort eval scores through `fused_topk_scores`. False:
    the dense path; True: the kernel wrapper on any two-tower model;
    "auto": the kernel on the card for two-tower models over corpora of
    ≥ 100,000 items (where it pays off), else the dense path."""
    if flag is False:
        return False
    if flag == "auto":
        return two_tower and n_items >= 100_000 and device_type == "cuda"
    return bool(flag) and two_tower


def fused_hits(topk_idx, pos_items, pos_valid):
    """(U, k) 0/1: is the j-th ranked item one of the user's positives."""
    hit = (topk_idx[:, :, None].long() == pos_items[:, None, :]) & pos_valid[:, None, :]
    return hit.any(dim=-1).to(torch.int32)


class EvalRunner:
    def __init__(self, model, config):
        self.model = model
        self.config = config
        self.maxk = max(config["topk"])
        self.eval_type = config["eval_type"]
        self._full_steps = {}
        self.train_split = None  # set by the caller for popularity metrics

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ---------------------------------------------------------- full sort

    def _make_full_step(self):
        model, maxk = self.model, self.maxk

        def step(batch):
            scores = model.full_sort_scores(batch)
            return mask_and_topk(
                scores,
                batch["hist_items"], batch["hist_len"],
                batch["pos_items"], batch["pos_len"],
                maxk,
            )

        return step

    def _make_fused_full_step(self, n_items: int):
        """Fast path for two-tower models: fused block scoring + bitmap
        masking + top-k (ops/topk_score.py), identical results to the dense
        path."""
        from oovrec_tpu_torch.ops.topk_score import (
            build_hist_bitmap,
            fused_topk_scores,
        )

        model, maxk = self.model, self.maxk

        def step(batch):
            user_e = model.user_tower(batch)
            item_e = model.item_tower()
            bm = build_hist_bitmap(batch["hist_items"], batch["hist_len"], n_items)
            _, topk_idx = fused_topk_scores(user_e, item_e, bm, k=maxk)
            pos = batch["pos_items"]
            pos_valid = (
                torch.arange(pos.shape[1], device=pos.device)[None, :]
                < batch["pos_len"][:, None]
            )
            return topk_idx, fused_hits(topk_idx, pos, pos_valid), batch["pos_len"]

        return step

    def _use_fused(self, n_items: int) -> bool:
        return fused_topk_rule(self.config.get("use_fused_topk", "auto"), self.device.type,
                               hasattr(self.model, "user_tower"), n_items)

    # ------------------------------------------------------------- entry

    @torch.no_grad()
    def evaluate(self, eval_loader, sample_eval_ratio=None, rng=None):
        """Run one evaluation pass; returns OrderedDict of metrics.

        `sample_eval_ratio` (with `rng`) skips full-sort batches after the
        first with probability 1 - ratio, the trainer's sampled validation
        (`runner.py:463-470` of the JAX package)."""
        self.model.eval()
        if isinstance(eval_loader, PlainEvalBatcher):
            return self._evaluate_value(eval_loader)
        if not isinstance(eval_loader, FullSortEvalBatcher):
            raise NotImplementedError(
                f"{type(eval_loader).__name__}: only full-sort and plain "
                "labelled eval are ported"
            )
        collector = Collector(self.config)
        if self.train_split is not None and (
            "data.count_items" in collector.need
            or "data.num_items" in collector.need
        ):
            collector.data_collect(self.train_split)
        key = eval_loader.item_num
        if key not in self._full_steps:
            if self._use_fused(eval_loader.item_num):
                self._full_steps[key] = self._make_fused_full_step(key)
            else:
                self._full_steps[key] = self._make_full_step()
        full_step = self._full_steps[key]
        for i, batch in enumerate(eval_loader):
            if (sample_eval_ratio is not None and i >= 1 and rng is not None
                    and rng.random() > sample_eval_ratio):
                continue
            db = to_device_batch(batch, self.device)
            topk_idx, pos_idx, pos_len = full_step(db)
            collector.collect_topk(
                pos_idx.cpu().numpy(), pos_len.cpu().numpy(), batch["weight"]
            )
            if "rec.items" in collector.need:
                collector.collect_items(topk_idx.cpu().numpy(), batch["weight"])
            if "rec.meanrank" in collector.need:
                scores = apply_masks(
                    self.model.full_sort_scores(db),
                    db["hist_items"], db["hist_len"],
                ).cpu().numpy()
                prs, ul, pl = meanrank_from_scores(
                    scores, batch["pos_items"], batch["pos_len"]
                )
                collector.collect_meanrank(prs, ul, pl, batch["weight"])
        return Evaluator(self.config).evaluate(collector.get_data_struct())

    def _evaluate_value(self, eval_loader: PlainEvalBatcher):
        """VALUE metrics over pooled (score, label) pairs
        (`runner.py:551-564` of the JAX package)."""
        collector = Collector(self.config)
        label = self.model.label_field
        for batch in eval_loader:
            scores = self.model.predict(to_device_batch(batch, self.device))
            collector.collect_scores(
                scores.float().cpu().numpy(), batch[label], batch["weight"]
            )
        return Evaluator(self.config).evaluate(collector.get_data_struct())
