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
from oovrec_tpu_torch.models.general import (
    ADMMSLIM,
    DGCF,
    EASE,
    GCMC,
    NCL,
    NGCF,
    SGL,
    ItemKNN,
    LightGCN,
    NCEPLRec,
    Pop,
    Random,
    SLIMElastic,
    SpectralCF,
)
from oovrec_tpu_torch.models.sequential import (
    BERT4Rec,
    CORE,
    DIEN,
    DIN,
    FDSA,
    FOSSIL,
    FPMC,
    GCSAN,
    HGN,
    HRM,
    KSR,
    NARM,
    NPE,
    SHAN,
    SINE,
    SRGNN,
    STAMP,
    Caser,
    GRU4Rec,
    GRU4RecF,
    GRU4RecKG,
    LightSANs,
    NextItNet,
    RepeatNet,
    S3Rec,
    SASRec,
    SASRecF,
    SequentialRecommender,
    TransRec,
)


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Model [{name}] is not ported")
    return MODEL_REGISTRY[name]


__all__ = [
    "ADMMSLIM", "AFM", "AutoInt", "BERT4Rec", "BPR", "CORE", "Caser", "ContextRecommender",
    "DCN", "DCNV2", "DGCF", "DIEN", "DIN", "DSSM", "DeepFM", "DirectAU", "EASE", "EulerNet",
    "FDSA", "FFM", "FM", "FNN", "FOSSIL", "FPMC", "FieldSpec", "FiGNN", "FwFM", "GCMC", "GCSAN",
    "GRU4Rec", "GRU4RecF", "GRU4RecKG", "GeneralRecommender", "HGN", "HRM", "ItemKNN",
    "KD_DAGFM", "KSR", "LR", "LightGCN", "LightSANs", "MODEL_REGISTRY", "NARM", "NCEPLRec",
    "NCL", "NFM", "NGCF", "NPE", "NextItNet", "PNN", "Pop", "Random", "RepeatNet", "S3Rec",
    "SASRec", "SASRecF", "SGL", "SHAN", "SINE", "SLIMElastic", "SRGNN", "STAMP",
    "SequentialRecommender", "SpectralCF", "TransRec", "WideDeep", "get_model_class",
    "xDeepFM",
]
