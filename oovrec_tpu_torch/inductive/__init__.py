from oovrec_tpu_torch.inductive.hashes import hash_ids
from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper
from oovrec_tpu_torch.inductive.spec import InductiveSpec

__all__ = ["InductiveSpec", "RandomOOVMapper", "hash_ids"]
