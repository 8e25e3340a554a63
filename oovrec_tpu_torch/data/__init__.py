from oovrec_tpu_torch.data.dataloader import FullSortEvalBatcher, PlainEvalBatcher
from oovrec_tpu_torch.data.dataset import DatasetSplit
from oovrec_tpu_torch.data.sampler import Sampler

__all__ = ["DatasetSplit", "FullSortEvalBatcher", "PlainEvalBatcher", "Sampler"]
