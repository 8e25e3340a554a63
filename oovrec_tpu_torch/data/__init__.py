from oovrec_tpu_torch.data.dataloader import (
    FullSortEvalBatcher,
    NegSampleEvalBatcher,
    PlainEvalBatcher,
    TrainBatcher,
)
from oovrec_tpu_torch.data.dataset import Dataset, DatasetSplit
from oovrec_tpu_torch.data.inductive_dataset import InductiveDataset
from oovrec_tpu_torch.data.sampler import Sampler

__all__ = [
    "Dataset", "DatasetSplit", "FullSortEvalBatcher", "InductiveDataset",
    "NegSampleEvalBatcher", "PlainEvalBatcher", "Sampler", "TrainBatcher",
]
