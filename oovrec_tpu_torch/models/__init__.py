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
from oovrec_tpu_torch.models.sequential import (
    BERT4Rec,
    FPMC,
    GRU4Rec,
    NARM,
    SASRec,
    STAMP,
    SequentialRecommender,
)

# the JAX package's other sequential models (`models/sequential/`)
UNPORTED_SEQUENTIAL = frozenset({
    "Caser", "NextItNet", "DIN", "DIEN", "HGN", "FOSSIL", "TransRec", "SHAN", "NPE", "HRM",
    "CORE", "SRGNN", "GCSAN", "LightSANs", "SINE", "GRU4RecF", "SASRecF", "FDSA", "RepeatNet",
    "GRU4RecKG", "KSR", "S3Rec",
})


def get_model_class(name: str):
    if name in UNPORTED_SEQUENTIAL:
        raise NotImplementedError(
            f"the sequential model [{name}] is not ported (ROADMAP.md, queue 1 item 4: "
            "sequential models)")
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Model [{name}] is not ported")
    return MODEL_REGISTRY[name]


__all__ = [
    "AFM", "AutoInt", "BERT4Rec", "BPR", "ContextRecommender", "DCN", "DCNV2", "DSSM", "DeepFM",
    "DirectAU", "EulerNet", "FFM", "FM", "FNN", "FPMC", "FieldSpec", "FiGNN", "FwFM",
    "GRU4Rec", "GeneralRecommender", "KD_DAGFM", "LR", "MODEL_REGISTRY", "NARM", "NFM", "PNN",
    "SASRec", "STAMP", "SequentialRecommender", "UNPORTED_SEQUENTIAL", "WideDeep",
    "get_model_class", "xDeepFM",
]
