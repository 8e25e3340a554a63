"""Shared pieces of the knowledge models.

`KnowledgeRecommender` is a `GeneralRecommender` over the shared
item / entity id space of `data/kg_dataset.py`: `n_entities` entities (the
first `n_items` of them the items) and `n_relations` relations (the last
one `[UI-Relation]`), both handed over by `build_model_and_state` from the
dataset. Every table lookup with a gradient goes through
`ops/embed_grad.py:gather_rows` (`lookup`), whose backward is the
sort-and-segment kernel on the card; a lookup of a fixed index buffer
takes the buffer's plan.

None of these models is an ID tower or routes through `_route_side`: the
OOV regime trains them on their own ids, and the full-sort 7-slice eval
refuses them, as for the general models (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Optional

import torch

from oovrec_tpu_torch.models.base import GeneralRecommender
from oovrec_tpu_torch.ops.embed_grad import SegmentPlan, gather_rows
from oovrec_tpu_torch.utils.enums import ModelType


def lookup(table: torch.nn.Embedding, ids: torch.Tensor,
           plan: Optional[SegmentPlan] = None) -> torch.Tensor:
    """`table(ids)`, ids of any shape, through `gather_rows` (`plan`: the
    plan of fixed `ids` into the table's rows)."""
    return gather_rows(table.weight, ids, plan=plan)


class KnowledgeRecommender(GeneralRecommender):
    model_type = ModelType.KNOWLEDGE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 n_entities: int = 0, n_relations: int = 0, label_field: str = "label",
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.n_entities = int(n_entities)
        self.n_relations = int(n_relations)
        self.label_field = label_field
