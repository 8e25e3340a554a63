from oovrec_tpu_torch.inductive.hashes import hash_ids
from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper
from oovrec_tpu_torch.inductive.spec import InductiveSpec
from oovrec_tpu_torch.inductive.transform import OOVSimulator

__all__ = ["InductiveSpec", "OOVSimulator", "RandomOOVMapper", "hash_ids"]
