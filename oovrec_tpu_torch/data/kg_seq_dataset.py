"""Sequential + knowledge dataset.

Port of `oovrec_tpu/data/kg_seq_dataset.py`: the sequential examples and
leave-one-out of `SequentialDataset` over a corpus whose entity space is
item-aligned from its `.kg` / `.link` files (`KnowledgeBasedDataset`). The
MRO is SequentialDataset → KnowledgeBasedDataset → Dataset: the KG hooks
(`_load_data`, `_data_filtering`, `_remap_id_all`) run inside the base
pipeline, `build()` is the sequential one.

`create_dataset` builds it where the JAX package does: for GRU4RecKG and
KSR on a corpus with both files. Neither model can be built on it there
(flax refuses `n_entities`), and the port refuses the build with its own
error (`cli/quick_start.py:build_model_and_state`).
"""

from __future__ import annotations

from oovrec_tpu_torch.data.kg_dataset import KnowledgeBasedDataset
from oovrec_tpu_torch.data.sequential import SequentialDataset


class KGSeqDataset(SequentialDataset, KnowledgeBasedDataset):
    """The sequential dataset with the knowledge graph loaded beside it."""
