"""InductiveEvaluator — 7-way old/new slice evaluation over the `_ind` corpus.

Port of `oovrec_tpu/eval/inductive.py:53-524` on three paths.

Ranking (VALUE-metric) models: each labelled row is annotated with the
OOV flags and mapper buckets of its user and item, scored by
`model.predict`, and the (score, label) pairs are pooled per slice by the
row's user and item old/new masks (overall, old_users, new_users,
old_old, old_new, new_old, new_new).

Retrieval models, on full sort: one device pass per user batch computes
top-k for four item variants and the host assigns rows to slices with
user old/new masks:

    slice        rows (users)   item variant
    overall      all            full (unperturbed, like the base Collector)
    old_users    uid < n_old    full (perturbed)
    new_users    uid ≥ n_old    full (perturbed)
    old_old      uid < n_old    old items only
    old_new      uid < n_old    new items only
    new_old      uid ≥ n_old    old items only
    new_new      uid ≥ n_old    new items only

Retrieval models, on sampled negatives (the paper's uni250 protocol,
`_evaluate_sampled`): `model.predict` over the annotated expanded rows,
scattered into a (user slot, item) matrix per batch; the same four item
variants over that matrix, the slices by the slot users' old/new masks.

DHE / fDHE: the users and rows carry the hashes of their RAW ids (no
prime pad) and the item corpus is hashed once a pass, on the host, or on
the card under `dhe_on_device` (`inductive.py:60-85, 229-250, 495-525` of
the JAX package, whose corpus hashes always run on the host).

The slices keep the JAX package's semantics, including its documented
deviation from the reference on old_new/new_old (complementary item mask,
unshifted positive ids). Tie-breaking follows `use_perturbed_hits`: top-k
runs on column-permuted scores. The permutations come from
`host_rng(seed, "perturbed_hits")` drawn in the JAX order (three per batch
on the dense and sampled paths, one on the fused path), so both packages
rank alike.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from oovrec_tpu_torch.data.dataloader import NegSampleEvalBatcher
from oovrec_tpu_torch.data.transfer import to_device_batch
from oovrec_tpu_torch.eval.collector import Collector, Evaluator
from oovrec_tpu_torch.eval.full_sort import (
    sampled_matrices,
    variant_matrix_topk,
    variant_topk,
)
from oovrec_tpu_torch.eval.runner import fused_hits, fused_topk_rule
from oovrec_tpu_torch.inductive.dhe import model_hasher
from oovrec_tpu_torch.ops.topk_score import (
    NEG_INF as K_NEG_INF,
    build_hist_bitmap,
    fused_topk_scores,
    pack_bitplane,
    stable_topk,
)
from oovrec_tpu_torch.utils.enums import EvaluatorType
from oovrec_tpu_torch.utils.seeding import host_rng

SLICES = (
    "overall", "old_users", "new_users",
    "old_old", "old_new", "new_old", "new_new",
)
VARIANTS = ("overall", "full", "old", "new")


class InductiveEvaluator:
    def __init__(self, model, config, n_old_users: int, n_old_items: int,
                 mapper=None):
        self.model = model
        self.config = config
        self.n_old_users = n_old_users
        self.n_old_items = n_old_items
        self.mapper = mapper
        self.maxk = max(config["topk"])
        self.use_perturbed = bool(config.get("use_perturbed_hits", True))
        self._step = None
        self._fused = False
        self._rng = host_rng(int(config["seed"] or 2020), "perturbed_hits")
        self.dhe_hasher = model_hasher(model, config)

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------ device

    def _make_step(self):
        """Dense pass computing all four item variants over one (U, N)
        score matrix (`variant_topk`)."""
        model, maxk = self.model, self.maxk

        def step(batch, all_item_e, perms, imasks):
            scores = model.score_against(batch, all_item_e)
            ti, pi, plen = variant_topk(
                scores,
                batch["hist_items"], batch["hist_len"],
                batch["pos_items"], batch["pos_len"],
                maxk, perms, imasks,
            )
            return {v: (ti[i], pi[i], plen[i]) for i, v in enumerate(VARIANTS)}

        return step

    def _use_fused(self, n_ext: int) -> bool:
        """`fused_topk_rule`, as `EvalRunner._use_fused`: block-candidate
        kernel scoring for two-tower models on large corpora, on the card."""
        return fused_topk_rule(self.config.get("use_fused_topk", "auto"), self.device.type,
                               hasattr(self.model, "user_tower"), n_ext)

    def _make_fused_step(self, n_ext: int):
        """Block-candidate variant of `_make_step`: no (B, N) score matrix.

        The old/new item split partitions the corpus, so per-class kernel
        passes give exact slice top-ks AND the full-corpus top-k: top-k(old
        ∪ new) ⊆ top-k(old) ∪ top-k(new), a 2k-candidate merge. Four kernel
        launches per batch (old/new × unpermuted/permuted). Perturbed
        tie-breaking is exact: the item axis is permuted BEFORE scoring
        (item rows gathered through `perm`, history/class bitmaps rebuilt
        in permuted coordinates), one shared permutation per batch."""
        model, maxk = self.model, self.maxk
        dev = self.device
        ids = torch.arange(n_ext, device=dev)
        old_keep = (ids >= 1) & (ids < self.n_old_items)
        new_keep = ids >= self.n_old_items
        xo = pack_bitplane(~old_keep)[None, :]  # exclusions of the old slice
        xn = pack_bitplane(~new_keep)[None, :]

        def merge(va, ia, vb, ib):
            tv, p = stable_topk(torch.cat([va, vb], dim=1), maxk)
            return tv, torch.gather(torch.cat([ia, ib], dim=1), 1, p)

        def unpermute(perm, idx):
            # dead slots past the corpus (N < k) keep their index ≥ N
            idx = idx.long()
            return torch.where(idx < n_ext, perm[idx.clamp(max=n_ext - 1)], idx)

        def hits(topk_idx, topk_val, pos_items, pos_valid):
            live = topk_val > K_NEG_INF / 2  # excluded-column candidates
            return fused_hits(topk_idx, pos_items, pos_valid) * live.to(torch.int32)

        def step(batch, all_item_e, perm):
            user_e = model.user_tower(batch)
            bm = build_hist_bitmap(
                batch["hist_items"], batch["hist_len"], n_ext, exclude_col0=False
            )

            def fused(items, bitmap):
                return fused_topk_scores(user_e, items, bitmap, k=maxk)

            v_o0, i_o0 = fused(all_item_e, bm | xo)
            v_n0, i_n0 = fused(all_item_e, bm | xn)
            v_all0, i_all0 = merge(v_o0, i_o0, v_n0, i_n0)

            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(n_ext, device=dev)
            item_p = all_item_e[perm]
            bm_p = build_hist_bitmap(
                inv[batch["hist_items"]], batch["hist_len"], n_ext,
                exclude_col0=False,
            )
            xo_p = pack_bitplane(~old_keep[perm])[None, :]
            xn_p = pack_bitplane(~new_keep[perm])[None, :]
            v_op, i_op = fused(item_p, bm_p | xo_p)
            v_np, i_np = fused(item_p, bm_p | xn_p)
            i_op, i_np = unpermute(perm, i_op), unpermute(perm, i_np)
            v_allp, i_allp = merge(v_op, i_op, v_np, i_np)

            pos, plen = batch["pos_items"], batch["pos_len"]
            P = pos.shape[1]
            pos_valid = torch.arange(P, device=dev)[None, :] < plen[:, None]
            pv_old = pos_valid & (pos >= 1) & (pos < self.n_old_items)
            pv_new = pos_valid & (pos >= self.n_old_items)
            return {
                "overall": (i_all0, hits(i_all0, v_all0, pos, pos_valid), plen),
                "full": (i_allp, hits(i_allp, v_allp, pos, pos_valid), plen),
                "old": (i_op, hits(i_op, v_op, pos, pv_old), pv_old.sum(dim=1)),
                "new": (i_np, hits(i_np, v_np, pos, pv_new), pv_new.sum(dim=1)),
            }

        return step

    def _all_item_embeddings(self, n_ext_items: int):
        item_ids = np.arange(n_ext_items, dtype=np.int64)
        buckets = np.zeros(n_ext_items, np.int64)
        if self.mapper is not None:
            oov = item_ids >= self.n_old_items
            if oov.any():
                buckets[oov] = self.mapper.item_buckets(item_ids[oov])
        ids = torch.from_numpy(item_ids).to(self.device)
        dhe = dhe_ids = None
        if self.dhe_hasher is not None:
            if self.dhe_hasher.on_device:
                dhe_ids = ids
            else:
                dhe = torch.from_numpy(self.dhe_hasher.hash_ids(item_ids)).to(self.device)
        return self.model.all_item_embeddings(
            ids, torch.from_numpy(buckets).to(self.device),
            item_dhe=dhe, item_dhe_ids=dhe_ids,
        )

    def _variant_perms_masks(self, n_ext: int):
        """Stacked (4, N) tie-break permutations + item masks for the
        (overall, full, old, new) variant axis. `overall` is unperturbed;
        the three perturbed variants draw fresh permutations per batch
        (`filtered_collector.py:38-55`)."""
        identity = np.arange(n_ext)
        if self.use_perturbed:
            draw = self._rng.permutation
            perms = np.stack([identity, draw(n_ext), draw(n_ext), draw(n_ext)])
        else:
            perms = np.broadcast_to(identity, (4, n_ext)).copy()
        ar = np.arange(n_ext)
        ones = np.ones(n_ext, np.int32)
        old = (ar < self.n_old_items).astype(np.int32)
        imasks = np.stack([ones, ones, old, 1 - old])
        return (
            torch.from_numpy(perms).to(self.device),
            torch.from_numpy(imasks).to(self.device),
        )

    # ------------------------------------------------------------- entry

    @torch.no_grad()
    def evaluate_model(self, test_loader):
        """`evaluate_model` (`inductive/evaluator.py:136-179`): the value
        slices for ranking models, full-sort retrieval otherwise."""
        self.model.eval()
        if self.config["eval_type"] == EvaluatorType.VALUE:
            return self._evaluate_value(test_loader)
        if isinstance(test_loader, NegSampleEvalBatcher):
            return self._evaluate_sampled(test_loader)
        n_ext = test_loader.item_num
        all_item_e = self._all_item_embeddings(n_ext)
        if self._step is None:
            self._fused = self._use_fused(n_ext)
            self._step = (
                self._make_fused_step(n_ext) if self._fused else self._make_step()
            )

        collectors = {s: Collector(self.config) for s in SLICES}
        for batch in test_loader:
            db = to_device_batch(self._annotate_users(batch), self.device)
            if self._fused:
                perm = (
                    self._rng.permutation(n_ext)
                    if self.use_perturbed
                    else np.arange(n_ext)
                )
                out = self._step(
                    db, all_item_e, torch.from_numpy(perm).to(self.device)
                )
            else:
                perms, imasks = self._variant_perms_masks(n_ext)
                out = self._step(db, all_item_e, perms, imasks)

            users = np.asarray(batch["user_id"])
            w = np.asarray(batch["weight"]) > 0
            old_u = (users < self.n_old_users) & w
            new_u = (users >= self.n_old_users) & w
            host = {
                v: (pos_idx.cpu().numpy(), pos_len.cpu().numpy())
                for v, (_, pos_idx, pos_len) in out.items()
            }
            self._collect_slices(collectors, host, w, old_u, new_u)
        return self._results(collectors)

    def _evaluate_sampled(self, test_loader: NegSampleEvalBatcher):
        """Retrieval slices over scattered uni-N score matrices
        (`inductive.py:358-430` of the JAX package)."""
        model, maxk = self.model, self.maxk
        n_ext = test_loader.item_num
        n_users = test_loader.max_users
        slots = np.arange(n_users)
        collectors = {s: Collector(self.config) for s in SLICES}
        for batch in test_loader:
            batch = self._annotate_rows(batch)
            db = to_device_batch(batch, self.device)
            perms, imasks = self._variant_perms_masks(n_ext)
            mat, pos = sampled_matrices(db, model.predict(db), model.iid_field,
                                        n_users, n_ext)
            _, pos_idx, pos_len = variant_matrix_topk(mat, pos, maxk, perms, imasks)
            host = {v: (pos_idx[i].cpu().numpy(), pos_len[i].cpu().numpy())
                    for i, v in enumerate(VARIANTS)}

            slot_users = np.asarray(batch["slot_users"])
            w = slots < int(batch["n_users"])
            old_u = (slot_users < self.n_old_users) & w
            new_u = (slot_users >= self.n_old_users) & w
            self._collect_slices(collectors, host, w, old_u, new_u)
        return self._results(collectors)

    def _collect_slices(self, collectors, host, w, old_u, new_u) -> None:
        """Each slice's rows of its item variant, rows without a slice
        positive dropped."""
        plan = {
            "overall": ("overall", w),
            "old_users": ("full", old_u),
            "new_users": ("full", new_u),
            "old_old": ("old", old_u),
            "old_new": ("new", old_u),
            "new_old": ("old", new_u),
            "new_new": ("new", new_u),
        }
        for slice_name, (variant, rows) in plan.items():
            pos_idx, pos_len = host[variant]
            keep = rows & (pos_len > 0)
            if keep.any():
                collectors[slice_name].collect_topk(pos_idx[keep], pos_len[keep])

    def _results(self, collectors):
        evaluator = Evaluator(self.config)
        results: "OrderedDict[str, OrderedDict]" = OrderedDict()
        for s in SLICES:
            struct = collectors[s].get_data_struct()
            results[s] = (
                evaluator.evaluate(struct) if struct.has("rec.topk") else OrderedDict()
            )
        return results

    def _evaluate_value(self, test_loader):
        """Ranking-model slices: per-row user/item old-new masks over pooled
        (score, label) pairs — the VALUE branch of the reference's
        FilteredCollector (`filtered_collector.py:70-79`,
        `collector_filter.py:179-203`)."""
        model = self.model
        collectors = {s: Collector(self.config) for s in SLICES}
        uidf, iidf = model.uid_field, model.iid_field
        for batch in test_loader:
            batch = self._annotate_rows(batch)
            scores = model.predict(to_device_batch(batch, self.device))
            scores = scores.float().cpu().numpy()
            labels = np.asarray(batch[model.label_field])
            w = np.asarray(batch["weight"]) > 0
            old_u = np.asarray(batch[uidf]) < self.n_old_users
            old_i = np.asarray(batch[iidf]) < self.n_old_items
            plan = {
                "overall": w,
                "old_users": w & old_u,
                "new_users": w & ~old_u,
                "old_old": w & old_u & old_i,
                "old_new": w & old_u & ~old_i,
                "new_old": w & ~old_u & old_i,
                "new_new": w & ~old_u & ~old_i,
            }
            for s, rows in plan.items():
                if rows.any():
                    collectors[s].collect_scores(scores[rows], labels[rows])

        evaluator = Evaluator(self.config)
        results: "OrderedDict[str, OrderedDict]" = OrderedDict()
        for s in SLICES:
            struct = collectors[s].get_data_struct()
            results[s] = (
                evaluator.evaluate(struct) if struct.has("rec.score") else OrderedDict()
            )
        return results

    def _annotate_rows(self, batch: dict) -> dict:
        """Host-side OOV flags/buckets for the rows' user AND item columns."""
        out = dict(batch)
        uidf, iidf = self.model.uid_field, self.model.iid_field
        for field, n_old, bucket_fn in (
            (uidf, self.n_old_users,
             self.mapper.user_buckets if self.mapper else None),
            (iidf, self.n_old_items,
             self.mapper.item_buckets if self.mapper else None),
        ):
            ids = np.asarray(out[field], np.int64)
            oov = (ids >= n_old).astype(np.int32)
            out[field + "_oov"] = oov
            if bucket_fn is not None and oov.any():
                out[field + "_bucket"] = np.where(oov > 0, bucket_fn(ids), 0)
            else:
                out[field + "_bucket"] = np.zeros_like(ids)
            if self.dhe_hasher is not None:
                self.dhe_hasher.annotate_batch(out, field, 0, padded_when_flagged=False)
        return out

    def _annotate_users(self, batch: dict) -> dict:
        """Host-side OOV flags/buckets for the user block."""
        out = dict(batch)
        users = np.asarray(batch["user_id"], np.int64)
        oov = (users >= self.n_old_users).astype(np.int32)
        out["user_id_oov"] = oov
        buckets = np.zeros_like(users)
        if self.mapper is not None and oov.any():
            buckets = np.where(oov > 0, self.mapper.user_buckets(users), 0)
        out["user_id_bucket"] = buckets
        if self.dhe_hasher is not None:
            # eval hashes the RAW inductive id (no prime pad)
            self.dhe_hasher.annotate_batch(out, "user_id", 0, padded_when_flagged=False)
        return out
