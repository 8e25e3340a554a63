"""The knowledge models (`oovrec_tpu/models/knowledge/`): CKE, CFKG and
KGAT, KGCN and MKR, KTUP, KGNNLS and RippleNet, KGIN and MCCLK, over the
shared item / entity id space of `data/kg_dataset.py`."""

from oovrec_tpu_torch.models.knowledge.base import KnowledgeRecommender
from oovrec_tpu_torch.models.knowledge.cfkg import CFKG
from oovrec_tpu_torch.models.knowledge.cke import CKE
from oovrec_tpu_torch.models.knowledge.kgat import KGAT
from oovrec_tpu_torch.models.knowledge.more import KGCN, MKR
from oovrec_tpu_torch.models.knowledge.more2 import KGNNLS, KTUP, RippleNet
from oovrec_tpu_torch.models.knowledge.more3 import KGIN, MCCLK

__all__ = ["CFKG", "CKE", "KGAT", "KGCN", "KGIN", "KGNNLS", "KTUP", "KnowledgeRecommender",
           "MCCLK", "MKR", "RippleNet"]
