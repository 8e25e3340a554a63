"""Evaluation runner: loader → device step → collector → metrics.

Port of `oovrec_tpu/eval/runner.py:24-148, 353-564` on three paths:
  * full sort (retrieval models): the dense step (`mask_and_topk` over
    `full_sort_scores`) and the fused step
    (`ops/topk_score.py:fused_topk_scores` over the two towers); the
    sequential models' examples (`SeqFullSortEvalBatcher`) take the dense
    step (they have no user tower);
  * sampled negatives (`NegSampleEvalBatcher`, the `uniN` / `popN`
    modes): for RANKING metrics, `model.predict` over the expanded rows,
    scattered into a (users, items) matrix per batch, then top-k and the
    positives' ranks; for VALUE metrics, the pooled (score, label) pairs
    of those rows;
  * value (ranking models): `PlainEvalBatcher` rows → `model.predict` →
    pooled (score, label) pairs → AUC / LogLoss / RMSE / MAE;
  * the scanned eval (`device_eval`, `runner.py:150-347` of the JAX
    package) for RANKING metrics over full-sort and uni-N loaders. Both
    RANKING paths run the same steps with no host read between them and
    copy the hits of the whole pass back once (`_ranking_pass`); the
    scanned eval copies a chunk of batches (bounded by
    `device_eval_max_elements`) to the device at once where the per-batch
    path copies each batch, and its full sort re-blocks to about
    `device_eval_score_elements` scores a step while it runs. Its step is
    the one the per-batch path picks (kernel 1 by `fused_topk_rule`),
    where the JAX scanned pass always takes `mask_and_topk`: both give the
    exact top-k, ties to the lowest index. A sequential loader keeps its
    `eval_batch_size // n_items` rows a batch there, as in JAX.
On the mesh (`:58-77, 401-406, 570-589` there) each data coordinate's
ranks evaluate its users (the eval loaders shard by data coordinate,
`data/dataloader.py:_process_info`), each rank's metrics keep 12 decimals,
`parallel/distributed.py:map_reduce_metrics` takes their sample-weighted
mean over the data group and the result is rounded once; the scanned eval
is off (`:157`). The full sort keeps `fused_topk_rule` on each rank, over
the whole item tower (a sharded table's `dense()`), so kernel 1 runs per
rank and the hits are the dense path's.
"""

from __future__ import annotations

import numpy as np
import torch

from oovrec_tpu_torch.data.dataloader import (
    FullSortEvalBatcher,
    NegSampleEvalBatcher,
    PlainEvalBatcher,
)
from oovrec_tpu_torch.data.sequential import SeqFullSortEvalBatcher
from oovrec_tpu_torch.data.transfer import host_signature, stack_to_device, to_device_batch
from oovrec_tpu_torch.eval.collector import (
    Collector,
    Evaluator,
    meanrank_from_scores,
)
from oovrec_tpu_torch.parallel.distributed import group_size, map_reduce_metrics
from oovrec_tpu_torch.eval.full_sort import (
    apply_masks,
    mask_and_topk,
    matrix_topk,
    sampled_matrices,
)
from oovrec_tpu_torch.utils.enums import EvaluatorType, ModelType


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
    def __init__(self, model, config, mesh=None):
        self.model = model
        self.config = config
        self.mesh = mesh
        self._n_local = 0.0
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

    def _full_step(self, n_items: int):
        """The full-sort step for a corpus of `n_items`, fused or dense."""
        if n_items not in self._full_steps:
            if self._use_fused(n_items):
                self._full_steps[n_items] = self._make_fused_full_step(n_items)
            else:
                self._full_steps[n_items] = self._make_full_step()
        return self._full_steps[n_items]

    # ------------------------------------------------------- scanned eval

    def _use_scanned_eval(self, eval_loader, collector) -> bool:
        """`device_eval` (`runner.py:150-185` of the JAX package): RANKING
        metrics over a full-sort loader (a model with `full_sort_scores`)
        or a uni-N loader, with a collector that needs only the hits;
        `auto` at >= 1,024 users."""
        flag = self.config.get("device_eval", "auto")
        if flag is False or self.mesh is not None or self.eval_type != EvaluatorType.RANKING:
            return False
        if type(eval_loader) in (FullSortEvalBatcher, SeqFullSortEvalBatcher):
            if not hasattr(self.model, "full_sort_scores"):
                return False
        elif type(eval_loader) is not NegSampleEvalBatcher:
            return False
        if collector.need & {"rec.items", "rec.meanrank", "rec.score", "data.label"}:
            return False
        if flag == "auto":
            # a sequential loader's rows are its examples (`runner.py:161-172`)
            rows = (len(eval_loader.split) if type(eval_loader) is SeqFullSortEvalBatcher
                    else len(eval_loader.uid_list))
            return rows >= 1024
        return bool(flag)

    def _ranking_pass(self, eval_loader, collector, step, weight_of, scanned: bool,
                      sample_eval_ratio=None, rng=None, each=None) -> None:
        """RANKING hits of every batch into `collector`: `step(db)` →
        (top-k indices, hits (U, k), pos_len (U,)) on the device. The hits
        stay there and come back in one copy at the end of the pass. The
        batches reach the device one copy a batch or, `scanned` (the
        scanned eval), one copy a chunk (`_stack_chunks`).
        `sample_eval_ratio` (with `rng`) skips batches after the first with
        probability 1 - ratio, the trainer's sampled validation
        (`runner.py:463-470` of the JAX package). `each(batch, db, top-k
        indices)` collects what the host needs a batch at a time."""
        hits, weights = [], []
        for batch, db in self._device_batches(eval_loader, scanned, sample_eval_ratio, rng):
            topk_idx, pos_idx, pos_len = step(db)
            hits.append(torch.cat([pos_idx.long(), pos_len.long()[:, None]], dim=1))
            weights.append(weight_of(batch))
            if each is not None:
                each(batch, db, topk_idx)
        if hits:
            out = torch.cat(hits).cpu().numpy()
            w = np.concatenate(weights)
            self._n_local += float(np.sum(w))
            collector.collect_topk(out[:, :-1], out[:, -1], w)

    def _device_batches(self, batches, scanned: bool, sample_eval_ratio=None, rng=None):
        """(host batch, its tensors on the device) in the loader's order."""
        if scanned:
            for chunk in self._stack_chunks(batches):
                stacked = stack_to_device(chunk, self.device)
                for i, batch in enumerate(chunk):
                    yield batch, {k: v[i] for k, v in stacked.items()}
            return
        for i, batch in enumerate(batches):
            if (sample_eval_ratio is not None and i >= 1 and rng is not None
                    and rng.random() > sample_eval_ratio):
                continue
            yield batch, to_device_batch(batch, self.device)

    def _stack_chunks(self, batches):
        """Host batches in chunks of at most `device_eval_max_elements`
        elements (`runner.py:265-294` of the JAX package), one chunk
        buffered at a time; a change of shape starts a new chunk."""
        it = iter(batches)
        first = next(it, None)
        if first is None:
            return
        per_batch = sum(int(np.asarray(v).size) for v in first.values())
        max_el = float(self.config.get("device_eval_max_elements") or 5e8)
        chunk = max(1, int(max_el // max(1, per_batch)))
        buf, sig = [first], host_signature(first)
        for b in it:
            s = host_signature(b)
            if len(buf) == chunk or s != sig:
                yield buf
                buf = []
            sig = s
            buf.append(b)
        yield buf

    # ------------------------------------------------------------- entry

    def _evaluator(self) -> Evaluator:
        """Several ranks keep 12 decimals before the map-reduce."""
        return Evaluator(self.config, decimal_place=12 if self._ranks() > 1 else None)

    def _ranks(self) -> int:
        return 1 if self.mesh is None else group_size(self.mesh.data_group)

    @torch.no_grad()
    def evaluate(self, eval_loader, sample_eval_ratio=None, rng=None):
        """Run one evaluation pass; returns OrderedDict of metrics (on
        several ranks the map-reduced dict, keys sorted, rounded once).

        `sample_eval_ratio` (with `rng`) skips full-sort batches after the
        first with probability 1 - ratio, the trainer's sampled validation
        (`runner.py:463-470` of the JAX package)."""
        self._n_local = 0.0
        result = self._evaluate(eval_loader, sample_eval_ratio, rng)
        if self.mesh is None:
            return result
        result = map_reduce_metrics(result, int(self._n_local), group=self.mesh.data_group)
        if self._ranks() > 1:
            dp = int(self.config["metric_decimal_place"])
            result = type(result)((k, round(float(v), dp)) for k, v in result.items())
        return result

    def _evaluate(self, eval_loader, sample_eval_ratio=None, rng=None):
        self.model.eval()
        if isinstance(eval_loader, PlainEvalBatcher):
            return self._evaluate_value(eval_loader)
        if isinstance(eval_loader, NegSampleEvalBatcher):
            # the joined feature columns are read only by context models
            eval_loader.join_features = (
                getattr(self.model, "model_type", None) == ModelType.CONTEXT)
            if self.eval_type == EvaluatorType.VALUE:
                return self._evaluate_value(eval_loader, sample_eval_ratio, rng)
            return self._evaluate_neg(eval_loader, sample_eval_ratio, rng)
        if not isinstance(eval_loader, (FullSortEvalBatcher, SeqFullSortEvalBatcher)):
            raise NotImplementedError(
                f"{type(eval_loader).__name__}: only full-sort, sampled-negative "
                "and plain labelled eval are ported"
            )
        collector = Collector(self.config)
        if self.train_split is not None and (
            "data.count_items" in collector.need
            or "data.num_items" in collector.need
        ):
            collector.data_collect(self.train_split)
        scanned = sample_eval_ratio is None and self._use_scanned_eval(eval_loader, collector)
        full_step = self._full_step(eval_loader.item_num)

        def each(batch, db, topk_idx):
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

        # the scanned full sort re-blocks to about `device_eval_score_elements`
        # scores a step (users are independent, so the blocking does not
        # touch the metrics), and restores the loader's blocking afterwards
        restore = None
        if (scanned and type(eval_loader) is FullSortEvalBatcher
                and eval_loader.process_count == 1):
            block = int(self.config.get("device_eval_score_elements") or (1 << 24))
            want = max(1, block // max(1, eval_loader.item_num))
            if want > eval_loader.users_per_batch:
                restore = eval_loader.users_per_batch
                eval_loader.users_per_batch = min(want, max(1, len(eval_loader.uid_list)))
        try:
            self._ranking_pass(eval_loader, collector, full_step,
                               lambda batch: batch["weight"], scanned, sample_eval_ratio, rng,
                               each)
        finally:
            if restore is not None:
                eval_loader.users_per_batch = restore
        return self._evaluator().evaluate(collector.get_data_struct())

    def _evaluate_neg(self, eval_loader: NegSampleEvalBatcher, sample_eval_ratio=None,
                      rng=None):
        """RANKING metrics over uni-N batches (`runner.py:353-370,
        432-490` of the JAX package): the rows' scores scattered per user
        slot, top-k against the positives; each user slot in range collects
        its hits."""
        collector = Collector(self.config)
        scanned = sample_eval_ratio is None and self._use_scanned_eval(eval_loader, collector)
        model, n_users, n_items = self.model, eval_loader.max_users, eval_loader.item_num
        off = eval_loader.slot_offset
        slots = np.arange(n_users)

        def step(db):
            mat, pos = sampled_matrices(db, model.predict(db), model.iid_field, n_users, n_items)
            return matrix_topk(mat, pos, self.maxk)

        def weight_of(batch):
            return ((slots >= off) & (slots < off + int(batch["n_users"]))).astype(np.float32)

        self._ranking_pass(eval_loader, collector, step, weight_of, scanned, sample_eval_ratio,
                           rng)
        return self._evaluator().evaluate(collector.get_data_struct())

    def _evaluate_value(self, eval_loader, sample_eval_ratio=None, rng=None):
        """VALUE metrics over pooled (score, label) pairs of plain labelled
        or uni-N rows (`runner.py:531-564` of the JAX package)."""
        collector = Collector(self.config)
        label = self.model.label_field
        for i, batch in enumerate(eval_loader):
            if (sample_eval_ratio is not None and i >= 1 and rng is not None
                    and rng.random() > sample_eval_ratio):
                continue
            scores = self.model.predict(to_device_batch(batch, self.device))
            self._n_local += float(np.sum(batch["weight"]))
            collector.collect_scores(
                scores.float().cpu().numpy(), batch[label], batch["weight"]
            )
        return self._evaluator().evaluate(collector.get_data_struct())
