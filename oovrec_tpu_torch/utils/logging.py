"""Console + file logging.

The port's copy of `oovrec_tpu/utils/logging.py` (stdlib only), so the CLI
logs `test result: ...` and the slice lines as the JAX CLI does. The logger
is named `oovrec_torch`, so the two packages' loggers stay apart in one
process.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime

_COLORS = {
    "black": "30",
    "red": "31",
    "green": "32",
    "yellow": "33",
    "blue": "34",
    "pink": "35",
    "cyan": "36",
    "white": "37",
}


def set_color(log: str, color: str, highlight: bool = True) -> str:
    index = _COLORS.get(color, "37")
    prev = "\033[1;" if highlight else "\033[0;"
    return f"{prev}{index}m{log}\033[0m"


def init_logger(config=None, name: str = "oovrec_torch") -> logging.Logger:
    """Configure a console + optional file logger.

    If `config` carries `model`/`dataset`, a log file is created under
    `./log/<model>/<model>-<dataset>-<timestamp>.log` like the reference.
    """
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)

    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(sh)

    if config is not None and config.get("model") and config.get("dataset"):
        log_dir = os.path.join("./log", str(config["model"]))
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%b-%d-%Y_%H-%M-%S")
        path = os.path.join(
            log_dir, f"{config['model']}-{config['dataset']}-{stamp}.log"
        )
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)

    return logger
