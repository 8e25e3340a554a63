from oovrec_tpu_torch.train.hyper_tuning import HyperTuning
from oovrec_tpu_torch.train.optimizers import Optimizer, build_optimizer
from oovrec_tpu_torch.train.trainer import Trainer

__all__ = ["HyperTuning", "Optimizer", "Trainer", "build_optimizer"]
