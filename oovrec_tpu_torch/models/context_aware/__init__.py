from oovrec_tpu_torch.models.context_aware.dcnv2 import DCNV2
from oovrec_tpu_torch.models.context_aware.widedeep import WideDeep
from oovrec_tpu_torch.models.context_aware.xdeepfm import xDeepFM

__all__ = ["DCNV2", "WideDeep", "xDeepFM"]
