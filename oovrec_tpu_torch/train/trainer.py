"""Trainer: train step, epoch loop and the inductive OOV regime.

Port of `oovrec_tpu/train/trainer.py`:
  * one step computes `model.calculate_loss(batch)`, its gradient over
    every parameter (a parameter the loss does not reach gets a zero
    gradient, as `jax.grad` gives) and one optimizer update
    (`train/optimizers.py`, the optax chain);
  * the frozen step updates only the parameters whose name carries
    `oov_bucket` or `oov_mlp` (`_is_oov_param_path`, :44-49): the others
    keep their values, moments and per-leaf counts, while the shared Adam
    count advances (`_make_step` :220-263 with `_select_opt_state`
    :919-939);
  * the OOV-simulation sub-epoch (`fit` :669-691): a Bernoulli keep of each
    batch with `oov_train_ratio`, the `OOVSimulator` transform on the kept
    ones, the frozen step under `oov_freeze_embedding`, and under
    `oov_freeze_skip_optim` a rollback of the optimizer state to a true
    copy taken before the sub-epoch;
  * mixed mode (`oov_only_epoch: false`): `_augment_batch` :563-581;
  * BatchNorm running statistics (DCNv2) move in every training step's
    forward, the frozen sub-epoch's included (the JAX freeze mask covers
    params only), and ride the checkpoint as buffers of the model's
    `state_dict`;
  * the host path's batches come through `data/prefetch.py:maybe_prefetch`
    (a thread assembling them ahead when `worker` > 0, :391);
  * `learner: sparse_adam` on the host path: for a model that declares
    its ID tables as pure row lookups (`sparse_table_fields`: BPR,
    DirectAU) an unfrozen step takes the row-sparse form of the lazy rule
    (`_sparse_step`: the batch's rows gathered, row gradients, kernel 6 on
    the touched rows), as the device epoch does; the JAX host path sweeps
    the whole tables with the same rule;
  * the device-resident epoch (`train/device_epoch.py`: pairwise,
    pointwise and plain loaders, DHE / fDHE ids under `dhe_on_device`)
    for the normal epoch, and for the OOV-only sub-epoch of pairwise
    loaders, chosen by the JAX package's gates (`_train_epoch` :374-389,
    `_maybe_device_epoch` :508-537: `device_epoch: true`, or `auto` at >=
    100,000 rows); under `learner: sparse_adam` its ID tables take the
    row-sparse step through kernel 6;
  * `host_scan_steps` (`_host_scan_k` :339-364, the buffer and flush
    :437-470): K host batches of one signature stacked, copied to the
    device in one transfer and stepped in order; a remainder or a change
    of signature takes the per-step path. The trajectory is K = 1's: the
    same steps in the same order, dropout and the global step per step;
  * every dense step (the device epoch's, the host scan's and the
    per-step host path's) runs as a captured CUDA graph on the card
    (`train/cuda_graph.py`), the counterpart of the JAX package's compiled
    step and scan bodies; the row-sparse step runs eagerly;
  * DHE / fDHE (`:150-167`, `:462-470`): a `DHEHasher` over the model's
    keys annotates each host batch after its OOV transform with the hashes
    of the (prime-padded when flagged) user, item and negative ids, or
    with the id columns that the model hashes on the card
    (`dhe_on_device`);
  * dynamic hard negatives (`fit` :600-621): the loader's scorer is
    `model.predict` under `no_grad` on the live parameter tensors (the
    ones each step, captured or not, updates in place), run between steps
    and outside any capture, the module's train/eval mode untouched; such
    a loader takes the host path, one batch at a time, never prefetched;
  * a traditional model (`ModelType.TRADITIONAL`: Pop, ItemKNN, the host
    solves) trains no epoch: `fit` evaluates the valid split once, keeps
    it as the best result, saves checkpoint 0 and returns (`fit`
    :630-642);
  * validation through the port's `EvalRunner`, early stopping, the
    epoch log lines of the JAX trainer (`utils/logging.py`), the
    best-model checkpoint (the port's own `torch.save` format; the
    embedder state rides in it as the model's buffers) and the JSONL
    `metrics_log_path`;
  * `resume_checkpoint` also reads the JAX package's pickle checkpoints
    (`trainer.py:851-915`) without flax: `utils/jax_checkpoint.py` decodes
    their msgpack trees and maps params, `batch_stats`, the embedder
    state and the optimizer state of every chain onto the port's.
Randomness: batches, the keep draws, the simulator and the negatives come
from the JAX package's numpy streams (`host_rng(seed, "oov_regime")`,
`"train_shuffle_train"`, `"valid_sampling"`, the sampler's seed) bit for
bit; dropout draws from the trainer's `torch.Generator`, seeded from
`seed + 101`, which cannot match `jax.random`.

The mesh (`use_mesh`, `mesh`; `:90-100, 171-211` there): the trainer
makes the rank mesh (`parallel/mesh.py`), turns the `nn.Embedding` tables
that the row-shard rule picks into block-sharded tables under
`sharded_lookup: gspmd` (`parallel/sharded_embedding.py:shard_tables`),
broadcasts the starting state, and every step is the global batch's step
(`parallel/train_step.py:mesh_step`, eager): each rank takes its data
coordinate's rows of the global batch (`place_batch`, padded as
`pad_batch` pads it; a device epoch's batch likewise), the loss's batch
reductions taken over the data group, so every rank's loss is the global
batch's, and the gradients summed over the data group.
There is no host scan and no row-sparse step under the mesh (the JAX
package's rules). Checkpoints gather the sharded tables to their full form
(`host_copy`) and rank 0 alone writes; a resume converts stored layouts
(`reconcile_state`: sharded ↔ dense, another S) and takes the rank's
block; the best-model reload agrees across ranks first and broadcasts the
file where only some ranks hold it (`_resume_best_multiprocess`, `:796-846`
there). Every model trains on the mesh.

Observability, as the JAX trainer's (`:121-135, 702-704, 749-758, 769-770`
there): the JSONL `metrics_log_path`; TensorBoard (`utils/tensorboard.py`,
`tensorboard_dir`, off under `log_tensorboard: false` or without the
wheel): `Loss/Train` and `Loss/OOV` after each epoch's training,
`Valid_score` and `Valid/<metric>` after each validation, the hparams at
the end of `fit`; wandb (`utils/wandblogger.py`, `log_wandb`): each
validation's metrics under `valid/`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from oovrec_tpu_torch.data.prefetch import maybe_prefetch
from oovrec_tpu_torch.eval.collector import calculate_valid_score
from oovrec_tpu_torch.data.transfer import host_signature, stack_to_device, to_device_batch
from oovrec_tpu_torch.eval.runner import EvalRunner
from oovrec_tpu_torch.inductive.dhe import model_hasher
from oovrec_tpu_torch.inductive.transform import OOVSimulator
from oovrec_tpu_torch.models.layers import set_dropout_generator
from oovrec_tpu_torch.parallel.distributed import comm_device
from oovrec_tpu_torch.parallel.mesh import host_copy, maybe_mesh_from_config, place_batch
from oovrec_tpu_torch.parallel.sharded_embedding import (
    block_state,
    full_shapes,
    reconcile_layouts,
    reconcile_state,
    shard_tables,
)
from oovrec_tpu_torch.parallel.train_step import broadcast_state, mesh_step
from oovrec_tpu_torch.train.cuda_graph import StepGraphs
from oovrec_tpu_torch.train.device_epoch import (
    AUTO_MAX_BUCKETS,
    DEVICE_HASHES,
    DeviceEpoch,
    device_epoch_eligible,
)
from oovrec_tpu_torch.train.early_stopping import early_stopping
from oovrec_tpu_torch.train.optimizers import build_optimizer, clone_state
from oovrec_tpu_torch.train.sparse_update import (
    SparseTableState,
    gather_rows_for_batch,
    resolve_sparse_impl,
    sparse_adam_update_table,
    sparse_epoch_table_map,
)
from oovrec_tpu_torch.utils.enums import ModelType
from oovrec_tpu_torch.utils.jax_checkpoint import is_jax_checkpoint, read_jax_checkpoint
from oovrec_tpu_torch.utils.jax_params import (
    flax_from_state_dict,
    load_batch_stats,
    load_flax_params,
    opt_state_from_flax,
    set_embedder_state,
)
from oovrec_tpu_torch.utils.logging import init_logger
from oovrec_tpu_torch.utils.seeding import host_rng, torch_generator
from oovrec_tpu_torch.utils.tensorboard import TensorboardLogger
from oovrec_tpu_torch.utils.wandblogger import WandbLogger


def _is_oov_param_path(name: str) -> bool:
    """The freeze filter: trainable during a frozen OOV sub-epoch iff the
    parameter's name carries 'oov_bucket' or 'oov_mlp'."""
    return "oov_bucket" in name or "oov_mlp" in name


def _plain(value):
    """A config value as plain Python, what `torch.load(weights_only=True)`
    reads back: containers kept, anything else as its string."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    return str(value)


class Trainer:
    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.mesh = maybe_mesh_from_config(config)
        if self.mesh is not None:
            self._place_on_mesh(config, model)
        self.logger = init_logger(config)

        self.epochs = int(config["epochs"])
        self.eval_step = min(int(config["eval_step"]), self.epochs)
        self.stopping_step = int(config["stopping_step"])
        self.valid_metric_bigger = bool(config["valid_metric_bigger"])
        self.optimizer = build_optimizer(config)
        self.params: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.oov_params = {n for n in self.params if _is_oov_param_path(n)}
        self.opt_state = self.optimizer.init(self.params)

        self.start_epoch = 0
        self.cur_step = 0
        self.best_valid_score = None
        self.best_valid_result = None
        self.train_loss_dict: Dict[int, float] = {}
        self.oov_loss_dict: Dict[int, float] = {}
        self.saved_model_file = os.path.join(
            config.get("checkpoint_dir", "saved"),
            f"{config.get('model', type(model).__name__)}-{config.get('dataset', 'data')}.pth",
        )
        self.eval_runner = EvalRunner(model, config, mesh=self.mesh)
        self.metrics_log_path = config.get("metrics_log_path")
        self.wandblogger = WandbLogger(config)
        self.tensorboard = TensorboardLogger(
            config, base_dir=config.get("tensorboard_dir") or "./log_tensorboard")

        seed = int(config["seed"] or 0)
        self.train_oov = bool(config["train_oov"])
        self.oov_only_epoch = bool(config["oov_only_epoch"])
        self.oov_train_ratio = float(config["oov_train_ratio"] or 0.0)
        self.oov_freeze_embedding = bool(config["oov_freeze_embedding"])
        self.oov_freeze_skip_optim = bool(config["oov_freeze_skip_optim"])
        self.valid_sample_ratio = config["eval_valid_sample_ratio"]
        self._oov_rng = host_rng(seed, "oov_regime")
        self.oov_simulator: Optional[OOVSimulator] = None
        self.dropout_generator = torch_generator(seed + 101, model.device)
        set_dropout_generator(model, self.dropout_generator)
        self._global_step = 0
        self._device_epochs: Dict[tuple, DeviceEpoch] = {}
        self.step_graphs = StepGraphs(self)
        self.dhe_hasher = model_hasher(model, config)
        # the host path's row-sparse tables (learner: sparse_adam), unfrozen
        self.sparse_tables = sparse_epoch_table_map(
            self, model, getattr(model, "spec", None), frozen=False)
        self.sparse_impl = resolve_sparse_impl(config) if self.sparse_tables else None

    # ------------------------------------------------------------ mesh

    def _place_on_mesh(self, config, model) -> None:
        """Shard the tables the rule picks; start every rank from the same
        state."""
        kind = config["sharded_lookup"]
        shard_tables(model, self.mesh, int(config["row_shard_threshold"] or 4096),
                     kind="auto" if kind in (None, "gspmd") else kind,
                     capacity_factor=float(config["alltoall_capacity_factor"] or 2.0))
        broadcast_state(model, self.mesh)

    def _to_device(self, batch, loader=None) -> Dict[str, torch.Tensor]:
        """A host batch on the model's device; under the mesh this rank's
        rows of it (the whole batch where the loader already gives this
        rank's slice)."""
        device = self.model.device
        if self.mesh is None:
            return to_device_batch(batch, device)
        local = getattr(loader, "process_count", 1) == self.mesh.n_data > 1
        return place_batch(self.mesh, batch, device, local=local)

    def _barrier(self) -> None:
        if dist.is_initialized():
            flag = torch.zeros(1, device=comm_device())
            dist.all_reduce(flag)

    # ------------------------------------------------------------ steps

    def _step(self, batch: Dict[str, torch.Tensor], frozen: bool) -> torch.Tensor:
        """One training step. The dense step goes through its captured
        graph (`train/cuda_graph.py`; eagerly on the CPU); the row-sparse
        step always runs eagerly: kernel 6 takes its bias corrections as
        host floats at each launch."""
        if frozen or not self.sparse_tables:
            loss = self.step_graphs.step(batch, self.oov_params if frozen else None)
        else:
            loss = self._sparse_step(batch, self.sparse_tables, self.sparse_impl)
        self._global_step += 1
        return loss

    def _apply_step(self, batch: Dict[str, torch.Tensor],
                    trainable: Optional[set] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Loss, gradient of every parameter and one optimizer update (only
        `trainable` moves when it is given; `count`, the optimizer's shared
        count on the device, for a captured step). → the detached loss.
        Under the mesh: the global batch's step from this rank's rows."""
        if self.mesh is not None:
            return mesh_step(self, batch, trainable, count)
        loss = self.model.calculate_loss(batch)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self.optimizer.step(self.params, grads, self.opt_state, trainable=trainable,
                            count=count)
        return loss.detach()

    def _sparse_step(self, batch: Dict[str, torch.Tensor], tables: dict,
                     impl: str) -> torch.Tensor:
        """One step with the row-sparse lazy Adam on the `tables`
        (`sparse_table_fields`): their rows for this batch gathered into
        leaves, the loss through the model's `_sparse_rows_<side>`
        override, the other parameters stepped by the optimizer, then each
        table's touched rows by kernel 6 (`impl` 'pallas') or its plain
        write-back ('xla'), with the optimizer's shared count."""
        params, state, opt = self.params, self.opt_state, self.optimizer
        names = {name + ".weight" for name, _f in tables.values()}
        rest = [n for n in params if n not in names]
        rows, nb, gathered = gather_rows_for_batch(params, batch, tables)
        for side, r in rows.items():
            nb["_sparse_rows_" + side] = r
        loss = self.model.calculate_loss(nb)
        leaves = [rows[s] for s in tables] + [params[n] for n in rest]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        opt.step({n: params[n] for n in rest}, dict(zip(rest, grads[len(tables):])), state)
        for (side, (name, _f)), g_rows in zip(tables.items(), grads):
            p = name + ".weight"
            sparse_adam_update_table(
                params[p], SparseTableState(state["mu"][p], state["nu"][p]),
                gathered[side], g_rows, state["count"], opt.learning_rate, impl=impl)
        return loss.detach()

    @torch.no_grad()
    def _score_candidates(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """The dynamic sampler's scorer: `model.predict` on (user, item)
        pairs with the live parameters (the JAX scorer's batch: the two id
        columns only). Its read-back orders it after the last step."""
        model, device = self.model, self.model.device
        batch = {model.uid_field: torch.from_numpy(users.astype(np.int64)).to(device),
                 model.iid_field: torch.from_numpy(items.astype(np.int64)).to(device)}
        return model.predict(batch).float().cpu().numpy()

    # ------------------------------------------------------------ epochs

    def _train_epoch(self, train_loader, epoch_idx: int, oov_transform=None,
                     keep_ratio: Optional[float] = None, frozen: bool = False):
        """One pass over the loader. `oov_transform` applies the OOV
        simulation to each kept batch; `keep_ratio` is the Bernoulli batch
        keep probability of the OOV sub-epoch. → the sum of the batch
        losses, None when no batch ran; the losses themselves stay in
        `last_losses`."""
        if oov_transform is None and keep_ratio is None and not frozen:
            de = self._maybe_device_epoch(train_loader)
            if de is not None:
                return self._run_device_epoch(de, epoch_idx)
        elif (keep_ratio is not None and oov_transform is self.oov_simulator
              and self.oov_simulator is not None):
            # the OOV-only sub-epoch on the device: flags, id masking, bucket
            # hashing and the Bernoulli step keep drawn there
            de = self._maybe_device_epoch(train_loader, oov=True, frozen=frozen)
            if de is not None:
                return self._run_device_epoch(de, epoch_idx)
        K = self._host_scan_k(train_loader) if self.mesh is None else 1
        loader = train_loader
        train_loader = maybe_prefetch(train_loader, self.config)
        self.model.train()
        device = self.model.device
        losses = []
        n_examples = 0
        t_epoch = time.time()
        buf: list = []
        buf_sig = None

        def flush():
            """A full group: stacked, one copy to the device, stepped in
            order; a remainder (or a group cut by a change of signature):
            the per-step path, as K = 1."""
            if len(buf) == K:
                stacked = stack_to_device(buf, device)
                for i in range(K):
                    losses.append(self._step({k: v[i] for k, v in stacked.items()}, frozen))
            else:
                for b in buf:
                    losses.append(self._step(to_device_batch(b, device), frozen))
            buf.clear()

        for batch in train_loader:
            if keep_ratio is not None and self._oov_rng.random() > keep_ratio:
                continue
            if oov_transform is not None:
                batch = oov_transform(batch)
            if self.dhe_hasher is not None:
                model = self.model
                for f in (model.uid_field, model.iid_field,
                          getattr(model, "neg_prefix", "neg_") + model.iid_field):
                    if f in batch:
                        self.dhe_hasher.annotate_batch(batch, f, model.spec.prime_pad,
                                                       padded_when_flagged=True)
            n_examples += int(np.asarray(batch["weight"]).sum())
            if K == 1:
                losses.append(self._step(self._to_device(batch, loader), frozen))
            else:
                sig = host_signature(batch)
                if buf and sig != buf_sig:
                    flush()
                buf_sig = sig
                buf.append(batch)
                if len(buf) == K:
                    flush()
            if self.config["oov_debug_skip_train"]:
                break
        if buf:
            flush()
        total_loss = None
        self.last_losses = np.zeros(0)
        if losses:
            vals = torch.stack(losses).double().cpu().numpy()
            if np.isnan(vals).any():
                raise ValueError("Training loss is nan")
            total_loss = float(vals.sum())
            self.last_losses = vals
        self.last_examples_per_sec = n_examples / max(time.time() - t_epoch, 1e-9)
        return total_loss

    def _host_scan_k(self, loader) -> int:
        """Batches a group on the host path (`trainer.py:339-364` of the
        JAX package): `host_scan_steps` K as given, or under `auto` 64 for
        loaders of at least 128 batches (1 below); 1 for dynamic negatives
        and under `oov_debug_skip_train`."""
        flag = self.config.get("host_scan_steps", "auto")
        if flag in (False, 0, 1, None):
            return 1
        if getattr(loader, "dynamic", False) or self.config["oov_debug_skip_train"]:
            return 1
        k = 64 if flag == "auto" else max(1, int(flag))
        if flag == "auto" and len(loader) < 2 * k:
            return 1
        return k

    def _maybe_device_epoch(self, train_loader, oov: bool = False,
                            frozen: bool = False) -> Optional[DeviceEpoch]:
        """The device-resident epoch for this loader, or None (the host
        path), by the JAX package's gates (`trainer.py:508-537`): the OOV
        sub-epoch takes the device only on a pairwise loader, with a hash
        function the device computes and at most 2^16 buckets a side."""
        if not device_epoch_eligible(self, train_loader, self.config):
            return None
        if oov:
            spec = getattr(self.model, "spec", None)
            if train_loader.mode != "pairwise":
                return None
            if spec is None or spec.hash_function not in DEVICE_HASHES:
                return None
            if max(spec.n_user_buckets or 0, spec.n_item_buckets or 0) > AUTO_MAX_BUCKETS:
                return None  # the JAX package's device mod bound, kept for the same path
        key = (id(train_loader), oov, frozen)
        if key not in self._device_epochs:
            self._device_epochs[key] = DeviceEpoch(self, train_loader, oov=oov, frozen=frozen)
        return self._device_epochs[key]

    def _run_device_epoch(self, de: DeviceEpoch, epoch_idx: int) -> float:
        """Run one device epoch: the losses are read once at its end, where
        the NaN check runs. → their sum."""
        t_epoch = time.time()
        vals = de.run(epoch_idx).double().cpu().numpy()
        if np.isnan(vals).any():
            raise ValueError("Training loss is nan")
        self._global_step += de.n_steps
        self.last_losses = vals
        self.last_examples_per_sec = de.n_real / max(time.time() - t_epoch, 1e-9)
        return float(vals.sum())

    def _augment_batch(self, batch: dict) -> dict:
        """Mixed-mode augmentation: sample ~ratio of the real rows,
        OOV-transform copies, append them into a fixed 2B-row batch (unused
        rows keep weight 0), shuffle."""
        n = len(batch["weight"])
        sel = self._oov_rng.random(n) < self.oov_train_ratio
        sel = sel & (batch["weight"] > 0)
        copy = {k: np.asarray(v)[sel] for k, v in batch.items()}
        copy = self.oov_simulator(copy)
        out = {}
        perm = self._oov_rng.permutation(2 * n)
        for k, v in batch.items():
            v = np.asarray(v)
            pad_shape = (2 * n - n - len(copy[k]),) + v.shape[1:]
            ext = np.concatenate([v, copy[k], np.zeros(pad_shape, v.dtype)], axis=0)
            out[k] = ext[perm]
        return out

    # ------------------------------------------------------------ fit

    def fit(self, train_loader, valid_loader=None, saved: bool = True,
            callback_fn=None):
        """Train with periodic validation and early stopping; → (best valid
        score, best valid result)."""
        if self.train_oov and self.oov_simulator is None:
            self.oov_simulator = OOVSimulator(
                self.model.spec, self.model.n_users, self.model.n_items,
                float(self.config["oov_feature_mask_rate"] or 0.0), self._oov_rng,
                uid_field=self.model.uid_field, iid_field=self.model.iid_field,
            )
        valid_rng = host_rng(int(self.config["seed"] or 0), "valid_sampling")
        if ((self.config["train_neg_sample_args"] or {}).get("dynamic")
                and hasattr(train_loader, "set_model_scorer")):
            train_loader.set_model_scorer(self._score_candidates)
        self.eval_runner.train_split = getattr(train_loader, "split", None)

        if getattr(self.model, "model_type", None) == ModelType.TRADITIONAL:
            # no gradient training: one valid pass, checkpoint 0
            if valid_loader is not None:
                self.best_valid_result = self.eval_runner.evaluate(valid_loader)
                self.best_valid_score = calculate_valid_score(
                    self.best_valid_result, self.config["valid_metric"])
            if saved:
                self._save_checkpoint(0)
            return self.best_valid_score, self.best_valid_result

        for epoch_idx in range(self.start_epoch, self.epochs):
            t0 = time.time()
            oov_loss = None
            if self.train_oov and not self.oov_only_epoch:
                train_loss = self._train_epoch(train_loader, epoch_idx,
                                               oov_transform=self._augment_batch)
            else:
                train_loss = self._train_epoch(train_loader, epoch_idx)
            self.train_loss_dict[epoch_idx] = train_loss
            self._log_metrics({
                "epoch": epoch_idx, "train_loss": train_loss,
                "examples_per_sec": round(self.last_examples_per_sec, 1),
            }, head="train")

            if self.train_oov and self.oov_only_epoch:
                snapshot = (clone_state(self.opt_state)
                            if self.oov_freeze_embedding and self.oov_freeze_skip_optim
                            else None)
                oov_loss = self._train_epoch(
                    train_loader, epoch_idx, oov_transform=self.oov_simulator,
                    keep_ratio=self.oov_train_ratio, frozen=self.oov_freeze_embedding,
                )
                if snapshot is not None:
                    # into the live tensors, which the captured steps update
                    _copy_into(self.opt_state, snapshot)
                if oov_loss is not None:
                    self.oov_loss_dict[epoch_idx] = oov_loss
            self.logger.info(
                "epoch %d training [time: %.2fs, train loss: %s%s]" % (
                    epoch_idx, time.time() - t0,
                    f"{train_loss:.4f}" if train_loss is not None else "None",
                    f", oov loss: {oov_loss:.4f}" if oov_loss is not None else "",
                ))
            self.tensorboard.add_scalar("Loss/Train", train_loss, epoch_idx)
            if oov_loss is not None:
                self.tensorboard.add_scalar("Loss/OOV", oov_loss, epoch_idx)

            if self.eval_step <= 0 or valid_loader is None:
                if saved:
                    self._save_checkpoint(epoch_idx)
                continue
            if (epoch_idx + 1) % self.eval_step == 0:
                t1 = time.time()
                ratio = self.valid_sample_ratio
                ratio = ratio if (ratio is not None and 0 < ratio < 1) else None
                valid_result = self.eval_runner.evaluate(
                    valid_loader, sample_eval_ratio=ratio, rng=valid_rng)
                valid_score = calculate_valid_score(valid_result, self.config["valid_metric"])
                self.best_valid_score, self.cur_step, stop_flag, update_flag = early_stopping(
                    valid_score, self.best_valid_score, self.cur_step,
                    max_step=self.stopping_step, bigger=self.valid_metric_bigger,
                )
                self.logger.info("epoch %d evaluating [time: %.2fs, valid_score: %f]"
                                 % (epoch_idx, time.time() - t1, valid_score))
                self.logger.info(f"valid result: {dict(valid_result)}")
                if update_flag:
                    if saved:
                        self._save_checkpoint(epoch_idx)
                    self.best_valid_result = valid_result
                if callback_fn:
                    callback_fn(epoch_idx, valid_score)
                self._log_metrics({**{k: float(v) for k, v in valid_result.items()},
                                   "epoch": epoch_idx}, head="valid")
                self.wandblogger.log_metrics(dict(valid_result), head="valid")
                self.tensorboard.add_scalar("Valid_score", valid_score, epoch_idx)
                self.tensorboard.add_scalars("Valid", dict(valid_result), epoch_idx)
                if stop_flag:
                    self.logger.info("Finished training, best eval result in epoch %d"
                                     % (epoch_idx - self.cur_step * self.eval_step))
                    break
        self.tensorboard.add_hparams(self.best_valid_score)
        self.tensorboard.close()
        return self.best_valid_score, self.best_valid_result

    def _log_metrics(self, metrics: dict, head: str = "train") -> None:
        if not self.metrics_log_path:
            return
        os.makedirs(os.path.dirname(self.metrics_log_path) or ".", exist_ok=True)
        with open(self.metrics_log_path, "a") as f:
            f.write(json.dumps({"head": head, **metrics}) + "\n")

    # ------------------------------------------------------------ eval

    def evaluate(self, eval_loader, load_best_model: bool = True,
                 model_file: Optional[str] = None):
        if eval_loader is None:
            return None
        if load_best_model:
            path = model_file or self.saved_model_file
            if dist.is_initialized() and dist.get_world_size() > 1:
                self._resume_best_multiprocess(path)
            elif os.path.isfile(path):
                self.resume_checkpoint(path, params_only=True)
        return self.eval_runner.evaluate(eval_loader)

    def _resume_best_multiprocess(self, path: str) -> None:
        """The best-model reload on several ranks: every rank makes the
        same decision (a rank that skips a collective the others make hangs
        them). The ranks agree through an all-gather of who holds the
        file; when only some do (rank 0's write to a directory the others
        do not see), the first holder broadcasts the checkpoint."""
        have = torch.tensor([float(os.path.isfile(path))], device=comm_device())
        flags = [torch.zeros_like(have) for _ in range(dist.get_world_size())]
        dist.all_gather(flags, have)
        flags = torch.cat(flags).cpu().numpy() > 0
        if not flags.any():
            return
        if flags.all():
            self.resume_checkpoint(path, params_only=True)
            return
        src = int(np.argmax(flags))
        box = [torch.load(path, map_location="cpu", weights_only=True)
               if dist.get_rank() == src else None]
        dist.broadcast_object_list(box, src=src)
        self._load_state(box[0], params_only=True)

    # ------------------------------------------------------ checkpointing

    def _save_checkpoint(self, epoch: int, path: Optional[str] = None) -> None:
        """Config, epoch, early-stopping state, parameters and optimizer
        state, as plain Python and CPU tensors (`torch.save`)."""
        path = path or self.saved_model_file
        config = self.config.as_dict() if hasattr(self.config, "as_dict") else dict(self.config)
        if self.mesh is not None:
            # the sharded tables gathered to their full form (collectives
            # every rank joins); rank 0 alone writes
            params = host_copy(self.model.state_dict(), self.model)
            opt_state = host_copy(self.opt_state, self.model)
        else:
            params = {n: p.detach().cpu() for n, p in self.model.state_dict().items()}
            opt_state = _to_device(self.opt_state, "cpu")
        if not dist.is_initialized() or dist.get_rank() == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            torch.save({
                "config": _plain(config),
                "epoch": epoch,
                "cur_step": self.cur_step,
                "best_valid_score": self.best_valid_score,
                "params": params,
                "opt_state": opt_state,
            }, path)
        self._barrier()  # no rank reads the file before it is whole

    def resume_checkpoint(self, path: str, params_only: bool = False) -> dict:
        """Restore the model (and unless `params_only` the optimizer and
        early-stopping state) from the port's checkpoint or from one the
        JAX package's trainer wrote (`_resume_jax_checkpoint`). → the
        checkpoint's dict."""
        if is_jax_checkpoint(path):
            return self._resume_jax_checkpoint(path, params_only)
        state = torch.load(path, map_location="cpu", weights_only=True)
        self._load_state(state, params_only)
        return state

    def _load_state(self, state: dict, params_only: bool) -> None:
        """The port's checkpoint dict into the model (and the optimizer and
        the progress unless `params_only`): each stored table layout
        converted to the model's (`reconcile_state`: sharded ↔ dense,
        another S), each sharded table's block taken."""
        model = self.model
        shapes = full_shapes(model)
        model.load_state_dict(block_state(model, reconcile_state(shapes, state["params"])))
        if not params_only:
            _copy_into(self.opt_state, _reconcile_tree(model, shapes, state["opt_state"]))
            self._resume_progress(state)

    def _resume_jax_checkpoint(self, path: str, params_only: bool) -> dict:
        """A JAX package checkpoint (`trainer.py:883-915` there): the params
        through the weight bridge, `batch_stats` as the BatchNorm
        statistics, `estate` as the embedder state, the optimizer state of
        the chain this trainer's rule builds in JAX, and the epoch, patience
        and best score."""
        state = read_jax_checkpoint(path)
        model = self.model
        # the stored table layouts converted to the model's (a tree that
        # holds `embedding_sharded`, `trainer.py:882-915` there)
        target = _flax_target(model)
        reconcile_layouts(target, state["params"])
        load_flax_params(model, state["params"])
        if state["extra_vars"].get("batch_stats"):
            load_batch_stats(model, state["extra_vars"]["batch_stats"])
        if state["estate"]:
            set_embedder_state(model, state["estate"])
        if not params_only:
            _reconcile_flax_opt(target, state["opt_state"])
            opt = opt_state_from_flax(state["opt_state"], self.optimizer.rule, model)
            _copy_into(self.opt_state, block_state(model, opt))
            self._resume_progress(state)
        return state

    def _resume_progress(self, state: dict) -> None:
        self.start_epoch = int(state["epoch"]) + 1
        self.cur_step = int(state["cur_step"])
        best = state["best_valid_score"]
        self.best_valid_score = None if best is None else float(best)


def _to_device(state, device):
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to(device, copy=True)
    return state


def _flax_target(model) -> dict:
    """The model's flax-style param tree in the full form, each leaf a
    zero-stride placeholder of its shape."""
    zero = torch.zeros(())
    return flax_from_state_dict({k: zero.expand(shape) for k, shape in full_shapes(model).items()},
                                model)


def _reconcile_tree(model, shapes: dict, tree):
    """`reconcile_state` on each dict of an optimizer state that is keyed
    by the model's parameter names (the moments), then each sharded
    table's block taken."""
    def keyed(node):
        return any(k in shapes or k.rpartition(".")[0] + ".weight" in shapes
                   or k.rpartition(".")[0] + ".embedding_sharded" in shapes for k in node)

    def walk(node):
        if not isinstance(node, dict):
            return node
        if node and keyed(node):
            return reconcile_state(shapes, node)
        return {k: walk(v) for k, v in node.items()}

    return block_state(model, walk(tree))


def _reconcile_flax_opt(target: dict, opt_tree) -> None:
    """`reconcile_layouts` on every subtree of a JAX optimizer state that
    mirrors the param tree (the moments; `trainer.py:907-910` there)."""
    if not isinstance(opt_tree, dict):
        return
    if set(target) & set(opt_tree):
        reconcile_layouts(target, opt_tree)
    for v in opt_tree.values():
        _reconcile_flax_opt(target, v)


def _copy_into(target: dict, source: dict) -> None:
    """Load a saved optimizer state into the live one, tensors in place."""
    for k, v in source.items():
        if isinstance(v, dict):
            _copy_into(target[k], v)
        elif isinstance(v, torch.Tensor):
            target[k].copy_(v)
        else:
            target[k] = v
