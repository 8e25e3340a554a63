"""Model registry (`oovrec_tpu/models/__init__.py` get_model_class analog)."""

from oovrec_tpu_torch.models.base import MODEL_REGISTRY, GeneralRecommender
from oovrec_tpu_torch.models.bpr import BPR
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec
from oovrec_tpu_torch.models.context_aware import (
    AFM,
    DCN,
    DCNV2,
    DSSM,
    FFM,
    FM,
    FNN,
    KD_DAGFM,
    LR,
    NFM,
    PNN,
    AutoInt,
    DeepFM,
    EulerNet,
    FiGNN,
    FwFM,
    WideDeep,
    xDeepFM,
)
from oovrec_tpu_torch.models.directau import DirectAU


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Model [{name}] is not ported")
    return MODEL_REGISTRY[name]


__all__ = [
    "AFM", "AutoInt", "BPR", "ContextRecommender", "DCN", "DCNV2", "DSSM", "DeepFM", "DirectAU",
    "EulerNet", "FFM", "FM", "FNN", "FieldSpec", "FiGNN", "FwFM", "GeneralRecommender",
    "KD_DAGFM", "LR", "MODEL_REGISTRY", "NFM", "PNN", "WideDeep", "get_model_class", "xDeepFM",
]
