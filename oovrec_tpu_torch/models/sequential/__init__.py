"""The sequential family (`oovrec_tpu/models/sequential/`): GRU4Rec,
SASRec, NARM, STAMP, FPMC, BERT4Rec, Caser, NextItNet, DIN, DIEN, HGN,
FOSSIL, TransRec, SHAN, NPE, HRM, CORE, SRGNN, GCSAN, LightSANs, SINE,
GRU4RecF, SASRecF, FDSA, RepeatNet, GRU4RecKG, KSR and S3Rec: all 28 of
the JAX package's."""

from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last
from oovrec_tpu_torch.models.sequential.bert4rec import BERT4Rec
from oovrec_tpu_torch.models.sequential.convs import Caser, NextItNet
from oovrec_tpu_torch.models.sequential.din import DIEN, DIN
from oovrec_tpu_torch.models.sequential.featseq import FDSA, GRU4RecF, SASRecF
from oovrec_tpu_torch.models.sequential.gru4rec import GRU4Rec
from oovrec_tpu_torch.models.sequential.more import FPMC, NARM, STAMP
from oovrec_tpu_torch.models.sequential.more2 import FOSSIL, HGN, TransRec
from oovrec_tpu_torch.models.sequential.more3 import CORE, HRM, NPE, SHAN
from oovrec_tpu_torch.models.sequential.more4 import GCSAN, SINE, SRGNN, LightSANs
from oovrec_tpu_torch.models.sequential.more5 import KSR, GRU4RecKG, RepeatNet
from oovrec_tpu_torch.models.sequential.s3rec import S3Rec
from oovrec_tpu_torch.models.sequential.sasrec import SASRec

__all__ = ["BERT4Rec", "CORE", "Caser", "DIEN", "DIN", "FDSA", "FOSSIL", "FPMC", "GCSAN",
           "GRU4Rec", "GRU4RecF", "GRU4RecKG", "HGN", "HRM", "KSR", "LightSANs", "NARM", "NPE",
           "NextItNet", "RepeatNet", "S3Rec", "SASRec", "SASRecF", "SHAN", "SINE", "SRGNN",
           "STAMP", "SequentialRecommender", "TransRec", "gather_last"]
