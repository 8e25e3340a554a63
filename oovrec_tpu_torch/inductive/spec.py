"""Static inductive configuration shared by models, trainer and pipeline.

This is the hashable, trace-time-constant description of the OOV layer:
which mapper/embedder is active, bucket counts, hash function. The
trainable pieces (OOV bucket tables, embedder MLPs) live in model params;
the non-trainable pieces (feature matrices, LSH planes, DHE keys, KNN
neighbor tables) live in an `EmbedderState` dict (see factory.py).

Reference counterparts: factory args (`recbole/inductive/get_inductive.py:16-138`)
and the model-side wiring (`abstract_recommender.py:117-169`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

EMBEDDERS = ("lsh", "slsh", "dhe", "fdhe", "dnn", "knn", "mean", "zero")
MAPPERS = ("random",)


@dataclasses.dataclass(frozen=True)
class InductiveSpec:
    mapper: Optional[str] = None        # 'random' | None
    embedder: Optional[str] = None      # one of EMBEDDERS | None
    add_oov_buckets: bool = False
    n_user_buckets: int = 0
    n_item_buckets: int = 0
    hash_function: str = "3round"
    prime_pad: int = 112062759511
    # DHE / DNN MLP sizing
    dhe_num_hashes: int = 128
    dhe_layer_size: int = 512
    embedding_size: int = 64
    knn_neighbors: int = 2
    normalization_type: str = "per-feature"

    def __post_init__(self):
        if self.mapper is not None and self.mapper not in MAPPERS:
            raise NotImplementedError(f"mapper [{self.mapper}] not supported")
        if self.embedder is not None and self.embedder not in EMBEDDERS:
            raise NotImplementedError(f"embedder [{self.embedder}] not supported")

    @property
    def active(self) -> bool:
        return (
            self.mapper is not None
            or self.embedder is not None
            or self.add_oov_buckets
        )

    @property
    def needs_buckets(self) -> bool:
        """Does the model need trainable OOV bucket tables?"""
        return self.add_oov_buckets or self.embedder in ("lsh", "slsh")

    @property
    def needs_features(self) -> bool:
        return self.embedder in ("lsh", "slsh", "dnn", "fdhe", "knn")

    @property
    def trainable_embedder(self) -> bool:
        return self.embedder in ("dhe", "fdhe", "dnn")

    @staticmethod
    def from_config(config) -> "InductiveSpec":
        return InductiveSpec(
            mapper=config["inductive_mapper"],
            embedder=config["inductive_embedder"],
            add_oov_buckets=bool(config["add_oov_buckets"]),
            n_user_buckets=int(config.get("n_user_oov_buckets", 100)),
            n_item_buckets=int(config.get("n_item_oov_buckets", 100)),
            hash_function=config.get("oov_hash_function", "3round"),
            prime_pad=int(config.get("oov_prime_pad", 112062759511)),
            dhe_num_hashes=int(config.get("dhe_num_hashes", 128)),
            dhe_layer_size=int(config.get("dhe_layer_size", 512)),
            embedding_size=int(config.get("embedding_size", 64)),
            knn_neighbors=int(config.get("oov_knn_num_neighbors", 2)),
            normalization_type=config.get("oov_normalization_type", "per-feature"),
        )
