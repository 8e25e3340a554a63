from oovrec_tpu_torch.models.context_aware.xdeepfm import xDeepFM

__all__ = ["xDeepFM"]
