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
    CORE,
    DIEN,
    DIN,
    FOSSIL,
    FPMC,
    GCSAN,
    HGN,
    HRM,
    NARM,
    NPE,
    SHAN,
    SINE,
    SRGNN,
    STAMP,
    Caser,
    GRU4Rec,
    LightSANs,
    NextItNet,
    SASRec,
    SequentialRecommender,
    TransRec,
)

# the JAX package's other sequential models (`models/sequential/featseq.py`,
# `more5.py`, `s3rec.py`)
UNPORTED_SEQUENTIAL = frozenset({
    "GRU4RecF", "SASRecF", "FDSA", "RepeatNet", "GRU4RecKG", "KSR", "S3Rec",
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
    "AFM", "AutoInt", "BERT4Rec", "BPR", "CORE", "Caser", "ContextRecommender", "DCN", "DCNV2",
    "DIEN", "DIN", "DSSM", "DeepFM", "DirectAU", "EulerNet", "FFM", "FM", "FNN", "FOSSIL",
    "FPMC", "FieldSpec", "FiGNN", "FwFM", "GCSAN", "GRU4Rec", "GeneralRecommender", "HGN",
    "HRM", "KD_DAGFM", "LR", "LightSANs", "MODEL_REGISTRY", "NARM", "NFM", "NPE", "NextItNet",
    "PNN", "SASRec", "SHAN", "SINE", "SRGNN", "STAMP", "SequentialRecommender", "TransRec",
    "UNPORTED_SEQUENTIAL", "WideDeep", "get_model_class", "xDeepFM",
]
