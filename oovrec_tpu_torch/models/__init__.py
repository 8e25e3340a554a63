"""Model registry (`oovrec_tpu/models/__init__.py` get_model_class analog)."""

from oovrec_tpu_torch.models.base import MODEL_REGISTRY, GeneralRecommender
from oovrec_tpu_torch.models.bpr import BPR
from oovrec_tpu_torch.models.context import ContextRecommender, FieldSpec
from oovrec_tpu_torch.models.context_aware import DCNV2, FFM, FM, LR, DeepFM, WideDeep, xDeepFM
from oovrec_tpu_torch.models.directau import DirectAU


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Model [{name}] is not ported")
    return MODEL_REGISTRY[name]


__all__ = [
    "BPR", "ContextRecommender", "DCNV2", "DeepFM", "DirectAU", "FFM", "FM", "FieldSpec",
    "GeneralRecommender", "LR", "MODEL_REGISTRY", "WideDeep", "get_model_class", "xDeepFM",
]
