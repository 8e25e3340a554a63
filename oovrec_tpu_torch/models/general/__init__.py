"""The general models (`oovrec_tpu/models/general/`): the traditional
models, fitted once from the training split (Pop, Random, ItemKNN, EASE,
SLIMElastic, ADMMSLIM, NCEPLRec), the graph models on LightGCN's edge
propagation (LightGCN, NGCF, SGL, SpectralCF, GCMC, DGCF, NCL), the pair
and pointwise embedding models (NeuMF, DMF, SimpleX, FISM, NAIS, LINE,
ConvNCF, NNCF) and the models trained on user batches (MultiVAE,
MultiDAE, CDAE, RecVAE, MacridVAE, RaCT, ENMF)."""

from oovrec_tpu_torch.models.general.base import TraditionalRecommender
from oovrec_tpu_torch.models.general.itemknn import ItemKNN
from oovrec_tpu_torch.models.general.lightgcn import GraphModel, LightGCN
from oovrec_tpu_torch.models.general.more import EASE, MultiVAE
from oovrec_tpu_torch.models.general.more2 import CDAE, DMF, NGCF, SGL, MultiDAE, SimpleX
from oovrec_tpu_torch.models.general.more3 import ENMF, FISM, LINE, NAIS, ConvNCF, SLIMElastic
from oovrec_tpu_torch.models.general.more4 import ADMMSLIM, GCMC, RecVAE, SpectralCF
from oovrec_tpu_torch.models.general.more5 import DGCF, NCL, NNCF, MacridVAE, NCEPLRec
from oovrec_tpu_torch.models.general.neumf import NeuMF
from oovrec_tpu_torch.models.general.pop import Pop, Random
from oovrec_tpu_torch.models.general.ract import RaCT

__all__ = [
    "ADMMSLIM", "CDAE", "ConvNCF", "DGCF", "DMF", "EASE", "ENMF", "FISM", "GCMC", "GraphModel",
    "ItemKNN", "LINE", "LightGCN", "MacridVAE", "MultiDAE", "MultiVAE", "NAIS", "NCEPLRec",
    "NCL", "NGCF", "NNCF", "NeuMF", "Pop", "RaCT", "Random", "RecVAE", "SGL", "SLIMElastic",
    "SimpleX", "SpectralCF", "TraditionalRecommender",
]
