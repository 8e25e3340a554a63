from oovrec_tpu_torch.inductive.dhe import DHEHasher
from oovrec_tpu_torch.inductive.factory import build_embedder_state
from oovrec_tpu_torch.inductive.hashes import hash_ids
from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.inductive.transform import OOVSimulator

__all__ = ["DHEHasher", "InductiveSpec", "OOVSimulator", "RandomOOVMapper",
           "build_embedder_state", "hash_ids"]
