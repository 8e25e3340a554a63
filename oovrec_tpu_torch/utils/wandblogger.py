"""Weights & Biases mirroring of a run's metrics.

Port of `oovrec_tpu/utils/wandblogger.py`: off, every call a no-op, when
`log_wandb` is off or `wandb` fails to import or to start a run. The
trainer logs each validation's metrics under `valid/`;
`cli/run.py:backup_weights` logs each backup medium and raises an alert
when none succeeded.
"""

from __future__ import annotations


class WandbLogger:
    def __init__(self, config):
        self.config = config
        self.log_wandb = bool(config.get("log_wandb", False))
        self.setup_complete = False
        self._wandb = None
        if self.log_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=config.get("wandb_project", "oovrec_tpu"),
                    config=config.as_dict() if hasattr(config, "as_dict") else dict(config),
                )
                self.setup_complete = True
            except Exception:  # noqa: BLE001 — a run that cannot start turns the logger off
                self.log_wandb = False

    def log_metrics(self, metrics, head: str = "train") -> None:
        if not self.setup_complete:
            return
        payload = {
            (f"{head}/{k}" if head else k): v
            for k, v in metrics.items()
            if isinstance(v, (int, float))
        }
        self._wandb.log(payload)

    def log_raw(self, payload: dict, commit: bool = True) -> None:
        """`wandb.log` of the payload as it is (string values allowed:
        `cli/run.py:backup_weights` logs `file_backup_medium` this way)."""
        if self.setup_complete:
            self._wandb.log(payload, commit=commit)

    def alert(self, title: str, text: str) -> None:
        if self.setup_complete:
            self._wandb.alert(title=title, text=text)
