"""The general models (`oovrec_tpu/models/general/`): the traditional
models, fitted once from the training split (Pop, Random, ItemKNN, EASE,
SLIMElastic, ADMMSLIM, NCEPLRec), and the graph models on LightGCN's
edge propagation (LightGCN, NGCF, SGL, SpectralCF, GCMC, DGCF, NCL)."""

from oovrec_tpu_torch.models.general.base import TraditionalRecommender
from oovrec_tpu_torch.models.general.itemknn import ItemKNN
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, LightGCN
from oovrec_tpu_torch.models.general.more import EASE
from oovrec_tpu_torch.models.general.more2 import NGCF, SGL
from oovrec_tpu_torch.models.general.more3 import SLIMElastic
from oovrec_tpu_torch.models.general.more4 import ADMMSLIM, GCMC, SpectralCF
from oovrec_tpu_torch.models.general.more5 import DGCF, NCEPLRec, NCL
from oovrec_tpu_torch.models.general.pop import Pop, Random

__all__ = [
    "ADMMSLIM", "DGCF", "EASE", "GCMC", "GraphModel", "ItemKNN", "LightGCN", "NCEPLRec", "NCL",
    "NGCF", "Pop", "Random", "SGL", "SLIMElastic", "SpectralCF", "TraditionalRecommender",
]
