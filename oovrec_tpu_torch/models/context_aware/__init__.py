from oovrec_tpu_torch.models.context_aware.basic import FM, LR, DeepFM
from oovrec_tpu_torch.models.context_aware.dcnv2 import DCNV2
from oovrec_tpu_torch.models.context_aware.ffm import FFM
from oovrec_tpu_torch.models.context_aware.more import AFM, DCN, FNN, PNN, AutoInt, FwFM
from oovrec_tpu_torch.models.context_aware.more2 import DSSM, EulerNet, FiGNN
from oovrec_tpu_torch.models.context_aware.more3 import KD_DAGFM, NFM
from oovrec_tpu_torch.models.context_aware.widedeep import WideDeep
from oovrec_tpu_torch.models.context_aware.xdeepfm import xDeepFM

__all__ = ["AFM", "AutoInt", "DCN", "DCNV2", "DSSM", "DeepFM", "EulerNet", "FFM", "FM", "FNN",
           "FiGNN", "FwFM", "KD_DAGFM", "LR", "NFM", "PNN", "WideDeep", "xDeepFM"]
