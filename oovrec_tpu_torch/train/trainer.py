"""Trainer: train step, epoch loop and the inductive OOV regime.

Port of `oovrec_tpu/train/trainer.py` on its host per-batch path:
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
  * validation through the port's `EvalRunner`, early stopping, the
    best-model checkpoint (the port's own `torch.save` format: the JAX
    package's flax/msgpack file cannot be read where JAX is absent) and
    the JSONL `metrics_log_path`.
Randomness: batches, the keep draws, the simulator and the negatives come
from the JAX package's numpy streams (`host_rng(seed, "oov_regime")`,
`"train_shuffle_train"`, `"valid_sampling"`, the sampler's seed) bit for
bit; dropout draws from the trainer's `torch.Generator`, seeded from
`seed + 101`, which cannot match `jax.random`.

Raises NotImplementedError where a config asks for what is not ported:
the device-resident epoch (`device_epoch: true`) and `host_scan_steps` > 1
(the same math, TPU dispatch amortisation; `auto` takes the host path
here), a mesh, the DHE hasher and dynamic hard negatives. Tensorboard and
wandb are not ported and log nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from oovrec_tpu_torch.eval.collector import calculate_valid_score
from oovrec_tpu_torch.eval.runner import EvalRunner, to_device_batch
from oovrec_tpu_torch.inductive.transform import OOVSimulator
from oovrec_tpu_torch.models.layers import set_dropout_generator
from oovrec_tpu_torch.train.early_stopping import early_stopping
from oovrec_tpu_torch.train.optimizers import build_optimizer, clone_state
from oovrec_tpu_torch.utils.seeding import host_rng, torch_generator


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
        self._refuse_unported(config, model)

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
        self.eval_runner = EvalRunner(model, config)
        self.metrics_log_path = config.get("metrics_log_path")

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

    @staticmethod
    def _refuse_unported(config, model) -> None:
        if config["device_epoch"] is True or config["device_epoch"] == "true":
            raise NotImplementedError("the device-resident epoch (device_epoch) is not ported")
        scan = config["host_scan_steps"]
        if scan not in (None, False, 0, 1, "auto"):
            raise NotImplementedError(f"host_scan_steps={scan} is not ported")
        if config["use_mesh"]:
            raise NotImplementedError("mesh training (use_mesh) is not ported")
        if (config["train_neg_sample_args"] or {}).get("dynamic"):
            raise NotImplementedError("dynamic hard negatives are not ported")
        spec = getattr(model, "spec", None)
        if spec is not None and spec.embedder in ("dhe", "fdhe"):
            raise NotImplementedError(f"the [{spec.embedder}] hasher is not ported")

    # ------------------------------------------------------------ steps

    def _step(self, batch: Dict[str, torch.Tensor], frozen: bool) -> torch.Tensor:
        loss = self.model.calculate_loss(batch)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self.optimizer.step(self.params, grads, self.opt_state,
                            trainable=self.oov_params if frozen else None)
        self._global_step += 1
        return loss.detach()

    # ------------------------------------------------------------ epochs

    def _train_epoch(self, train_loader, epoch_idx: int, oov_transform=None,
                     keep_ratio: Optional[float] = None, frozen: bool = False):
        """One pass over the loader. `oov_transform` applies the OOV
        simulation to each kept batch; `keep_ratio` is the Bernoulli batch
        keep probability of the OOV sub-epoch. → the sum of the batch
        losses, None when no batch ran; the losses themselves stay in
        `last_losses`."""
        self.model.train()
        device = self.model.device
        losses = []
        n_examples = 0
        t_epoch = time.time()
        for batch in train_loader:
            if keep_ratio is not None and self._oov_rng.random() > keep_ratio:
                continue
            if oov_transform is not None:
                batch = oov_transform(batch)
            n_examples += int(np.asarray(batch["weight"]).sum())
            losses.append(self._step(to_device_batch(batch, device), frozen))
            if self.config["oov_debug_skip_train"]:
                break
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
        self.eval_runner.train_split = getattr(train_loader, "split", None)

        for epoch_idx in range(self.start_epoch, self.epochs):
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
                    self.opt_state = snapshot
                if oov_loss is not None:
                    self.oov_loss_dict[epoch_idx] = oov_loss

            if self.eval_step <= 0 or valid_loader is None:
                if saved:
                    self._save_checkpoint(epoch_idx)
                continue
            if (epoch_idx + 1) % self.eval_step == 0:
                ratio = self.valid_sample_ratio
                ratio = ratio if (ratio is not None and 0 < ratio < 1) else None
                valid_result = self.eval_runner.evaluate(
                    valid_loader, sample_eval_ratio=ratio, rng=valid_rng)
                valid_score = calculate_valid_score(valid_result, self.config["valid_metric"])
                self.best_valid_score, self.cur_step, stop_flag, update_flag = early_stopping(
                    valid_score, self.best_valid_score, self.cur_step,
                    max_step=self.stopping_step, bigger=self.valid_metric_bigger,
                )
                if update_flag:
                    if saved:
                        self._save_checkpoint(epoch_idx)
                    self.best_valid_result = valid_result
                if callback_fn:
                    callback_fn(epoch_idx, valid_score)
                self._log_metrics({**{k: float(v) for k, v in valid_result.items()},
                                   "epoch": epoch_idx}, head="valid")
                if stop_flag:
                    break
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
            if os.path.isfile(path):
                self.resume_checkpoint(path, params_only=True)
        return self.eval_runner.evaluate(eval_loader)

    # ------------------------------------------------------ checkpointing

    def _save_checkpoint(self, epoch: int, path: Optional[str] = None) -> None:
        """Config, epoch, early-stopping state, parameters and optimizer
        state, as plain Python and CPU tensors (`torch.save`)."""
        path = path or self.saved_model_file
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        config = self.config.as_dict() if hasattr(self.config, "as_dict") else dict(self.config)
        state = {
            "config": _plain(config),
            "epoch": epoch,
            "cur_step": self.cur_step,
            "best_valid_score": self.best_valid_score,
            "params": {n: p.detach().cpu() for n, p in self.model.state_dict().items()},
            "opt_state": _to_device(self.opt_state, "cpu"),
        }
        torch.save(state, path)

    def resume_checkpoint(self, path: str, params_only: bool = False) -> dict:
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["params"])
        if not params_only:
            _copy_into(self.opt_state, state["opt_state"])
            self.start_epoch = state["epoch"] + 1
            self.cur_step = state["cur_step"]
            self.best_valid_score = state["best_valid_score"]
        return state


def _to_device(state, device):
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to(device, copy=True)
    return state


def _copy_into(target: dict, source: dict) -> None:
    """Load a saved optimizer state into the live one, tensors in place."""
    for k, v in source.items():
        if isinstance(v, dict):
            _copy_into(target[k], v)
        elif isinstance(v, torch.Tensor):
            target[k].copy_(v)
        else:
            target[k] = v
