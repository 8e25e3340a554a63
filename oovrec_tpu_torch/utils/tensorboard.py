"""TensorBoard scalars and hparams of a training run.

Port of `oovrec_tpu/utils/tensorboard.py` (the JAX package's writer is
torch's too). Event files go under `<tensorboard_dir>/<model>-<dataset>-
<time>/`. Off under `log_tensorboard: false` or the environment variable
`OOVREC_DISABLE_TENSORBOARD`, and where `torch.utils.tensorboard` cannot
be imported (the `tensorboard` wheel absent): the writer is then None and
every call is a no-op. The trainer writes `Loss/Train`, `Loss/OOV`,
`Valid_score` and `Valid/<metric>` each epoch, and at the end of `fit` the
run's scalar config values against `hparam/best_valid_result`.
"""

from __future__ import annotations

import os
import time
from typing import Optional


def get_tensorboard(config, base_dir: str = "./log_tensorboard"):
    """SummaryWriter for this run, or None when disabled/unavailable."""
    if config.get("log_tensorboard") is False:
        return None
    if os.environ.get("OOVREC_DISABLE_TENSORBOARD"):
        return None  # test harness: hundreds of tiny runs, no TB value
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # noqa: BLE001 — tensorboard wheel absent
        return None
    name = "{}-{}-{}".format(
        config["model"], config["dataset"],
        time.strftime("%b-%d-%Y_%H-%M-%S"),
    )
    path = os.path.join(base_dir, name)
    os.makedirs(path, exist_ok=True)
    return SummaryWriter(path)


class TensorboardLogger:
    """Thin trainer-facing wrapper: per-epoch scalars + end-of-fit
    hparams, no-op when the writer is off."""

    def __init__(self, config, base_dir: str = "./log_tensorboard"):
        self._config = config
        self._base_dir = base_dir
        self._writer = None
        self._opened = False

    def _get(self):
        if not self._opened:
            self._opened = True
            self._writer = get_tensorboard(self._config, self._base_dir)
        return self._writer

    def add_scalar(self, tag: str, value, step: int) -> None:
        w = self._get()
        if w is not None and value is not None:
            w.add_scalar(tag, float(value), int(step))

    def add_scalars(self, head: str, metrics: dict, step: int) -> None:
        w = self._get()
        if w is None:
            return
        for k, v in (metrics or {}).items():
            try:
                w.add_scalar(f"{head}/{k}", float(v), int(step))
            except (TypeError, ValueError):
                continue

    def add_hparams(self, best_valid_score: Optional[float]) -> None:
        """`_add_hparam_to_tensorboard` analog: the run's scalar config
        values keyed against its best valid score."""
        w = self._get()
        if w is None or best_valid_score is None:
            return
        skip = {"model", "dataset", "config_files", "device", "mesh"}
        hp = {}
        for k in self._config.keys():
            if k in skip:
                continue
            v = self._config[k]
            if v is None:
                continue
            if not isinstance(v, (bool, str, float, int)):
                v = str(v)
            hp[k] = v
        hp["model"] = str(self._config["model"])
        hp["dataset"] = str(self._config["dataset"])
        try:
            w.add_hparams(hp, {"hparam/best_valid_result":
                               float(best_valid_score)})
        except Exception:  # noqa: BLE001 — exotic config values
            pass

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
            self._writer = None
            self._opened = False
