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
    CDAE,
    DGCF,
    DMF,
    EASE,
    ENMF,
    FISM,
    GCMC,
    LINE,
    NAIS,
    NCL,
    NGCF,
    NNCF,
    SGL,
    ConvNCF,
    ItemKNN,
    LightGCN,
    MacridVAE,
    MultiDAE,
    MultiVAE,
    NCEPLRec,
    NeuMF,
    Pop,
    RaCT,
    Random,
    RecVAE,
    SimpleX,
    SLIMElastic,
    SpectralCF,
)
from oovrec_tpu_torch.models.knowledge import (
    CFKG,
    CKE,
    KGAT,
    KGCN,
    KGIN,
    KGNNLS,
    KTUP,
    MCCLK,
    MKR,
    KnowledgeRecommender,
    RippleNet,
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
    "ADMMSLIM", "AFM", "AutoInt", "BERT4Rec", "BPR", "CDAE", "CFKG", "CKE", "CORE", "Caser",
    "ContextRecommender", "ConvNCF", "DCN", "DCNV2", "DGCF", "DIEN", "DIN", "DMF", "DSSM",
    "DeepFM", "DirectAU", "EASE", "ENMF", "EulerNet", "FDSA", "FFM", "FISM", "FM", "FNN",
    "FOSSIL", "FPMC", "FieldSpec", "FiGNN", "FwFM", "GCMC", "GCSAN", "GRU4Rec", "GRU4RecF",
    "GRU4RecKG", "GeneralRecommender", "HGN", "HRM", "ItemKNN", "KD_DAGFM", "KGAT", "KGCN",
    "KGIN", "KGNNLS", "KSR", "KTUP", "KnowledgeRecommender", "LINE", "LR", "LightGCN",
    "LightSANs", "MCCLK", "MKR", "MODEL_REGISTRY", "MacridVAE", "MultiDAE", "MultiVAE", "NAIS",
    "NARM", "NCEPLRec", "NCL", "NFM", "NGCF", "NNCF", "NPE", "NeuMF", "NextItNet", "PNN", "Pop",
    "RaCT", "Random", "RecVAE", "RepeatNet", "RippleNet", "S3Rec", "SASRec", "SASRecF", "SGL",
    "SHAN", "SINE", "SLIMElastic", "SRGNN", "STAMP", "SequentialRecommender", "SimpleX",
    "SpectralCF", "TransRec", "WideDeep", "get_model_class", "xDeepFM",
]
