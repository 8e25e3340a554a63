"""The sequential family (`oovrec_tpu/models/sequential/`): GRU4Rec,
SASRec, NARM, STAMP, FPMC and BERT4Rec. The others raise in
`models/__init__.py:get_model_class`."""

from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last
from oovrec_tpu_torch.models.sequential.bert4rec import BERT4Rec
from oovrec_tpu_torch.models.sequential.gru4rec import GRU4Rec
from oovrec_tpu_torch.models.sequential.more import FPMC, NARM, STAMP
from oovrec_tpu_torch.models.sequential.sasrec import SASRec

__all__ = ["BERT4Rec", "FPMC", "GRU4Rec", "NARM", "SASRec", "STAMP", "SequentialRecommender",
           "gather_last"]
