"""Device-resident training epochs: the host out of the loop.

Port of `oovrec_tpu/train/device_epoch.py`, in its three loader modes:
pairwise (the retrieval track, BPR-family), pointwise (ranking models
with sampled negatives) and plain (labelled rows, no negatives). The
epoch's split columns, its padding weights, the used-pair bitmap and the
user / item feature tables live on the card; each step slices its batch
from a per-epoch permutation, draws its negatives on the card and trains:

  * negatives: bounded masked resampling against a packed
    (n_users, ⌈n_items/32⌉) bitmap, the host sampler's semantics
    (`data/sampler.py`): the first unused of R draws, else a fallback draw.
    All R rounds are drawn at once as an (R, B) tensor, where the JAX
    package spends them lazily in a `while_loop` (its exit reads no host;
    a torch loop's would). Repeatable samplers draw once, without the
    bitmap; the popularity distribution draws from an alias table
    (`data/alias.py`);
  * pointwise (`:528-558`), the host batcher's layout
    (`data/dataloader.py:_make_batch`): every inter column tiled × T
    (`times`: 1 positive + T - 1 negatives), the negatives drawn for
    `tile(users, T - 1)`, the item column [positives ∥ negatives], labels
    [weight ∥ 0], `weight` tiled × T, and the user and item features
    joined by row gathers from the tables on the card;
  * plain (`:518-521`): the split's columns and `weight`, with the
    features joined as the host batcher joins them (the JAX plain epoch
    joins none, and a context model over feature tables fails there:
    ROADMAP.md §3). A sequential split's (n, L) item lists ride as they
    are: a column keeps its trailing shape (GRU4Rec, SASRec, NARM and STAMP
    under CE);
  * DHE / fDHE under `dhe_on_device` (`:195-224, :554-579`): each batch
    carries `<field>_dhe_id`, the effective id as one int64 column that
    the model hashes on the card; in the OOV sub-epoch a flagged user or
    item id is padded by `prime_pad` after the transform, and the negative
    column carries its raw id (the JAX package ships uint32 halves);
  * the OOV-simulation sub-epoch (pairwise loaders): option-of-3 flags,
    bucket hashes of the ids before masking (`ops/inthash_device.py`), id
    masking that clears flags, and the Bernoulli step keep, drawn for the
    whole epoch at its start and read once;
  * a frozen sub-epoch updates only the OOV parameters (the trainer's
    frozen step);
  * under `learner: sparse_adam` the ID tables take the row-sparse step
    (`train/sparse_update.py`): rows gathered per step, row gradients,
    touched-row lazy Adam through kernel 6.

The parameters, the optimizer state and the BatchNorm statistics are the
trainer's own tensors, updated in place (the JAX epoch donates them to one
compiled program and carries `batch_stats` through its scan). The JAX
epoch is one `lax.scan`; here the steps are a Python loop that never reads
the device: the keep decisions are read once at the epoch's start and the
losses once at its end, where the NaN check runs. Each dense step replays
the trainer's captured CUDA graph of `_apply_step` on the card
(`train/cuda_graph.py`); the row-sparse step runs eagerly.

Randomness: `jax.random` streams cannot be matched. The epoch draws from a
`torch.Generator` on the epoch's device seeded from `seed` and the epoch
index (the counterpart of `fold_in(dropout_key, 1_000_000 + epoch)`); the
normal epoch and the OOV sub-epoch of one epoch index share the seed, as
they share the key in JAX.

On the mesh (`:94-97, 316-344, 622-656` there) every rank builds the
same epoch from the same seeded generator (the permutation, the keep
decisions, the negatives and the OOV transform of the global batch) and
takes its data coordinate's rows of each step's batch
(`parallel/mesh.py:data_rows`) into the mesh step; the loader's step must
divide over the data axis (`device_epoch_eligible`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from oovrec_tpu_torch.data.alias import alias_draw, build_alias_table
from oovrec_tpu_torch.data.sampler import _MAX_RESAMPLE_ROUNDS
from oovrec_tpu_torch.ops.inthash_device import sim_buckets_device
from oovrec_tpu_torch.parallel.mesh import data_rows
from oovrec_tpu_torch.train.sparse_update import resolve_sparse_impl, sparse_epoch_table_map
from oovrec_tpu_torch.utils.seeding import host_rng, torch_generator

AUTO_MIN_ROWS = 100_000
AUTO_MAX_BUCKETS = 1 << 16  # the JAX package's device mod bound (OOV sub-epoch)
DEVICE_HASHES = ("mod", "fast", "3round", "64bit")


def build_used_bitmap(per_user_used, n_users: int, n_items: int,
                      device="cpu") -> torch.Tensor:
    """Pack the sampler's per-user used-item id lists into a (n_users,
    ⌈n_items/32⌉) int32 bitmap on `device` (bit j of word w set ⇔ item
    w*32+j is used by that user). Item 0 (PAD) is always marked used. Built
    where it lives: each (user, item) adds its bit to its word, and the
    distinct bits of one word sum to their OR."""
    W = -(-n_items // 32)
    lists = [np.asarray(x, np.int64) for x in per_user_used[:n_users]]
    u = torch.from_numpy(np.repeat(np.arange(len(lists)), [len(x) for x in lists])).to(device)
    it = torch.from_numpy(np.concatenate(lists) if lists else np.zeros(0, np.int64)).to(device)
    bit = torch.ones_like(it) << (it & 31)
    bit = torch.where(bit >= 2**31, bit - 2**32, bit).to(torch.int32)
    bm = torch.zeros(n_users * W, dtype=torch.int32, device=device)
    bm.index_add_(0, u * W + (it >> 5), bit)
    bm = bm.view(n_users, W)
    bm[:, 0] |= 1  # PAD column
    return bm


def device_epoch_flag(config):
    """`device_epoch` as True, False or 'auto' (None is 'auto')."""
    flag = config.get("device_epoch", "auto")
    if isinstance(flag, str):
        flag = {"true": True, "false": False}.get(flag.lower(), flag.lower())
    return flag


def device_epoch_eligible(trainer, loader, config) -> bool:
    """The JAX package's gates (`device_epoch.py:609-664`): a `TrainBatcher`
    with uniform or popularity sampling (one negative a row pairwise, any
    number pointwise, none plain) and no batch transform (BERT4Rec's
    masking stays on the host), no DHE hasher or one that hashes on the
    device (`dhe_on_device`), and a model whose loss reads only what the
    epoch provides (`supports_device_epoch`); under `auto`, at least
    AUTO_MIN_ROWS rows. Dynamic hard negatives need the live scorer per
    batch and stay on the host path. Under the mesh the global step must
    divide over the data axis (`mesh_ok`)."""
    from oovrec_tpu_torch.data.dataloader import TrainBatcher
    from oovrec_tpu_torch.data.transform import Equal

    flag = device_epoch_flag(config)
    if flag is False or not isinstance(loader, TrainBatcher):
        return False
    dist_ok = getattr(loader.sampler, "distribution", None) in ("uniform", "popularity")
    dist_ok = dist_ok and not loader.dynamic
    if loader.mode == "pairwise":
        sampling_ok = loader.times == 1 and dist_ok
    elif loader.mode == "pointwise":
        sampling_ok = loader.times >= 2 and dist_ok
    else:
        sampling_ok = loader.mode == "plain"
    hasher = getattr(trainer, "dhe_hasher", None)
    dhe_ok = hasher is None or hasher.on_device
    mesh = getattr(trainer, "mesh", None)
    mesh_ok = mesh is None or loader.step % mesh.n_data == 0
    if not (sampling_ok and dhe_ok and mesh_ok and isinstance(loader.transform, Equal)
            and getattr(trainer.model, "supports_device_epoch", False)):
        return False
    if flag == "auto":
        return len(loader.split) >= AUTO_MIN_ROWS
    return bool(flag)


class DeviceEpoch:
    """A whole-epoch runner bound to a trainer and a loader."""

    def __init__(self, trainer, loader, oov: bool = False, frozen: bool = False):
        self.mode = loader.mode  # "pairwise" | "pointwise" | "plain"
        if oov and self.mode != "pairwise":
            raise ValueError("the OOV sub-epoch runs on the device for pairwise loaders only")
        self.trainer = trainer
        model = trainer.model
        self.device = device = model.device
        self.oov, self.frozen = oov, frozen
        split = loader.split
        self.uid_field, self.iid_field = loader.uid_field, loader.iid_field
        self.neg_field = loader.neg_prefix + loader.iid_field
        self.label_field = loader.label_field
        # pointwise expansion: 1 positive + (times - 1) negatives a row
        self.times = int(getattr(loader, "times", 2) or 2)
        self.n_real = len(split)
        self.B = B = loader.step
        self.n_steps = max(-(-self.n_real // B), 1)
        n_pad = self.n_steps * B

        w = np.zeros(n_pad, np.float32)
        w[: self.n_real] = 1.0
        self.weights = torch.from_numpy(w).to(device)

        def pad_col(v):
            v = np.asarray(v)
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            tail = np.zeros((n_pad - self.n_real,) + v.shape[1:], v.dtype)
            return torch.from_numpy(np.concatenate([v, tail])).to(device)

        self.columns = {k: pad_col(v) for k, v in split.inter.items()}
        self.n_items = split.item_num
        sampler = loader.sampler
        sampled = self.mode in ("pairwise", "pointwise")
        self.bitmap = None
        if sampled and not getattr(sampler, "repeatable", False):
            self.bitmap = build_used_bitmap(
                sampler.used_ids[loader.phase], split.user_num, split.item_num, device)
        self.pop_tab = None
        pop_p = getattr(sampler, "_pop_p", None) if sampled else None
        if pop_p is not None:
            prob, alias = build_alias_table(pop_p)
            self.pop_tab = (torch.from_numpy(prob).to(device),
                            torch.from_numpy(alias).to(device))
        cfg = trainer.config
        self.rounds = int(cfg["device_epoch_rounds"] or _MAX_RESAMPLE_ROUNDS)
        # the feature tables, once on the card (the id column and `_len`
        # columns left out, f64 as f32), joined per step by row gathers
        self.user_feat = self.item_feat = None
        if self.mode in ("pointwise", "plain"):
            self.user_feat = _feature_tables(loader.user_feat, self.uid_field, device)
            self.item_feat = _feature_tables(loader.item_feat, self.iid_field, device)

        spec = getattr(model, "spec", None)
        # DHE / fDHE: the effective id ships for the model to hash on the card
        self.dhe_pad = int(spec.prime_pad) if trainer.dhe_hasher is not None else None
        if oov:
            sim = trainer.oov_simulator
            self.mask_rate = float(sim.mask_rate)
            self.keep_ratio = float(trainer.oov_train_ratio)
            self.n_orig_u, self.n_orig_i = sim.n_users, sim.n_items
            self.prime_pad = int(spec.prime_pad)
            self.hash_fn = spec.hash_function
            self.nub = int(spec.n_user_buckets or 0)
            self.nib = int(spec.n_item_buckets or 0)
        self.trainable = trainer.oov_params if frozen else None
        self.sparse_tables = sparse_epoch_table_map(trainer, model, spec, frozen)
        self.sparse_impl = resolve_sparse_impl(cfg) if self.sparse_tables else None
        self._zero = torch.zeros((), device=device)

    # ----------------------------------------------------------- sampling

    def generator(self, epoch_idx: int) -> torch.Generator:
        seed = int(self.trainer.config["seed"] or 0) + 101
        draw = host_rng(seed, f"device_epoch_{epoch_idx}").integers(2**62)
        return torch_generator(int(draw), self.device)

    def draw(self, gen: torch.Generator, shape) -> torch.Tensor:
        """Candidate items: uniform over [1, n_items), or the popularity
        distribution through the alias table."""
        if self.pop_tab is None:
            return torch.randint(1, self.n_items, shape, generator=gen, device=self.device)
        return alias_draw(gen, shape, *self.pop_tab)

    def sample_negs(self, gen: torch.Generator, users: torch.Tensor) -> torch.Tensor:
        """One negative a user: the first of R candidate draws that the user
        has not used, else a fallback draw (the host sampler keeps its last
        bad draw after R rounds)."""
        if self.bitmap is None:
            return self.draw(gen, users.shape)
        R = self.rounds
        draws = self.draw(gen, (R + 1,) + tuple(users.shape))
        cand = draws[:R]
        W = self.bitmap.shape[1]
        words = self.bitmap.view(-1)[users * W + (cand >> 5)]
        free = ((words >> (cand & 31)) & 1) == 0
        first = free.to(torch.int32).argmax(dim=0)  # the first unused round
        picked = cand.gather(0, first[None]).squeeze(0)
        return torch.where(free.any(dim=0), picked, draws[R])

    def oov_transform(self, gen, option, bu, bi, neg, bw) -> Dict[str, torch.Tensor]:
        """The device twin of `OOVSimulator.__call__`: option-of-3 flags,
        bucket hashes of the ids before masking, id masking that clears
        the flags (a masked padded id is IV PAD 0)."""
        B = bu.shape[0]
        pad_items = (option == 0) | (option == 2)
        pad_users = (option == 1) | (option == 2)
        zeros = torch.zeros(B, dtype=torch.int64, device=self.device)
        uflag, iflag = zeros + pad_users, zeros + pad_items
        ub = (sim_buckets_device(bu, self.n_orig_u, self.nub, self.hash_fn, self.prime_pad)
              if self.nub else zeros)
        ib = (sim_buckets_device(bi, self.n_orig_i, self.nib, self.hash_fn, self.prime_pad)
              if self.nib else zeros)
        if self.mask_rate > 0:
            mu, mi, mn = torch.rand((3, B), generator=gen, device=self.device) < self.mask_rate
            bu, bi, neg = (torch.where(m, 0, x) for m, x in ((mu, bu), (mi, bi), (mn, neg)))
            uflag, iflag = torch.where(mu, 0, uflag), torch.where(mi, 0, iflag)
        u, i = self.uid_field, self.iid_field
        return {u: bu, u + "_oov": uflag, u + "_bucket": ub,
                i: bi, i + "_oov": iflag, i + "_bucket": ib,
                self.neg_field: neg, "weight": bw}

    def add_dhe_ids(self, batch: Dict[str, torch.Tensor], field: str, flagged: bool) -> None:
        """`<field>_dhe_id`: the id, or where `flagged` and its OOV flag is
        set the id + prime_pad (`DHEHasher.annotate_batch` on the card)."""
        ids = batch.get(field)
        if ids is None:
            return
        flags = batch.get(field + "_oov") if flagged else None
        batch[field + "_dhe_id"] = ids if flags is None else torch.where(
            flags > 0, ids + self.dhe_pad, ids)

    def make_batch(self, bc: Dict[str, torch.Tensor], bw: torch.Tensor,
                   neg: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One normal (not OOV) step's batch from its rows `bc`, their
        weights `bw` and the drawn negatives `neg` (pairwise: one a row;
        pointwise: (T - 1)·B for `tile(users, T - 1)`; plain: None)."""
        uidf, iidf = self.uid_field, self.iid_field
        if self.mode == "pairwise":
            batch = dict(bc, weight=bw)
            batch[self.neg_field] = neg
            fields = (uidf, iidf, self.neg_field)
        elif self.mode == "pointwise":
            T = self.times
            batch = {k: v.repeat((T,) + (1,) * (v.dim() - 1)) for k, v in bc.items()}
            batch[iidf] = torch.cat([bc[iidf], neg])
            batch[self.label_field] = torch.cat([bw, bw.new_zeros((T - 1) * bw.shape[0])])
            batch["weight"] = bw.repeat(T)
            self.join_features(batch, batch[uidf], batch[iidf])
            fields = (uidf, iidf)
        else:
            batch = dict(bc, weight=bw)
            self.join_features(batch, bc[uidf], bc[iidf])
            fields = (uidf, iidf)
        if self.dhe_pad is not None:
            for f in fields:
                self.add_dhe_ids(batch, f, flagged=False)
        return batch

    def join_features(self, batch, users, items) -> None:
        """The item then the user feature columns of each row, gathered
        from the tables on the card (`_join_features`' order)."""
        for table, ids in ((self.item_feat, items), (self.user_feat, users)):
            for f, t in (table or {}).items():
                batch[f] = t[ids]

    # -------------------------------------------------------------- steps

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One training step on `batch` (tensors on the device): the
        trainer's parameters, optimizer state and BatchNorm statistics
        update in place. The dense step replays its captured graph on the
        card; the row-sparse step runs eagerly, by rule: kernel 6 takes
        its bias corrections as host floats at each launch. → the loss."""
        if self.sparse_tables:
            return self.trainer._sparse_step(batch, self.sparse_tables, self.sparse_impl)
        mesh = self.trainer.mesh
        if mesh is not None:
            batch = data_rows(mesh, batch)
        return self.trainer.step_graphs.step(batch, self.trainable)

    # -------------------------------------------------------------- epoch

    def batches(self, epoch_idx: int):
        """The epoch's kept batches in order, as (step, batch): the
        permutation, the keep decisions (read once), the negatives and the
        OOV transform, all drawn on the device."""
        gen = self.generator(epoch_idx)
        n_pad = self.weights.shape[0]
        perm = torch.randperm(n_pad, generator=gen, device=self.device)
        cols = {k: v[perm].view((self.n_steps, self.B) + v.shape[1:])
                for k, v in self.columns.items()}
        w = self.weights[perm].view(self.n_steps, self.B)
        keep = [True] * self.n_steps
        if self.oov:
            u = torch.rand(self.n_steps, generator=gen, device=self.device)
            keep = (u <= self.keep_ratio).tolist()  # the epoch's one read
            options = torch.randint(0, 3, (self.n_steps,), generator=gen, device=self.device)
        uidf, iidf = self.uid_field, self.iid_field
        for i in range(self.n_steps):
            if not keep[i]:
                continue
            bc = {k: v[i] for k, v in cols.items()}
            neg = None
            if self.mode == "pairwise":
                neg = self.sample_negs(gen, bc[uidf])
            elif self.mode == "pointwise":
                neg = self.sample_negs(gen, bc[uidf].repeat(self.times - 1))
            if self.oov:
                extras = {k: v for k, v in bc.items() if k not in (uidf, iidf)}
                batch = dict(extras, **self.oov_transform(
                    gen, options[i], bc[uidf], bc[iidf], neg, w[i]))
                if self.dhe_pad is not None:
                    # after the transform: the padded id where flagged; the
                    # negative column carries no flag, so its raw id
                    for f, flagged in ((uidf, True), (iidf, True), (self.neg_field, False)):
                        self.add_dhe_ids(batch, f, flagged)
            else:
                batch = self.make_batch(bc, w[i], neg)
            yield i, batch

    def run(self, epoch_idx: int) -> torch.Tensor:
        """Train one epoch. → the (n_steps,) losses on the device, 0 for the
        steps the Bernoulli keep skipped; `steps_run` counts the others."""
        self.trainer.model.train()
        losses = [self._zero] * self.n_steps
        self.steps_run = 0
        for i, batch in self.batches(epoch_idx):
            losses[i] = self.train_step(batch)
            self.steps_run += 1
        return torch.stack(losses)


def _feature_tables(feat, id_field: str, device) -> Optional[Dict[str, torch.Tensor]]:
    """A loader's feature tables on `device`, without the id column and
    the `_len` columns, int64 kept and f64 as f32; None when there are
    none."""
    if feat is None:
        return None
    out = {}
    for f, t in feat.items():
        if f == id_field or f.endswith("_len"):
            continue
        t = np.asarray(t)
        if t.dtype == np.float64:
            t = t.astype(np.float32)
        out[f] = torch.from_numpy(t).to(device)
    return out or None
