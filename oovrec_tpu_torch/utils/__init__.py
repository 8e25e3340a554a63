from oovrec_tpu_torch.utils.enums import (
    EvaluatorType,
    FeatureSource,
    FeatureType,
    InputType,
    ModelType,
)
from oovrec_tpu_torch.utils.seeding import host_rng, init_seed, torch_generator

__all__ = [
    "EvaluatorType",
    "FeatureSource",
    "FeatureType",
    "InputType",
    "ModelType",
    "host_rng",
    "init_seed",
    "torch_generator",
]
