"""Batch-level transforms.

Port of the dispatch of `oovrec_tpu/data/transform.py:196`
(`construct_transform`): None and 'Equal' are the identity. The sequence
transforms (mask / inverse / crop / reorder item sequences) and the
user-defined one raise: they come with the sequential models (ROADMAP.md,
queue 1, "Trainer leftovers" and "Sequential models").
"""

from __future__ import annotations

from typing import Optional

SEQUENCE_TRANSFORMS = frozenset({
    "MaskItemSequence", "mask_itemseq", "InverseItemSequence", "inverse_itemseq",
    "CropItemSequence", "crop_itemseq", "ReorderItemSequence", "reorder_itemseq",
    "UserDefinedTransform", "user_defined",
})


class Equal:
    def __call__(self, batch: dict) -> dict:
        return batch


def construct_transform(config, n_items: Optional[int] = None):
    name = config["transform"]
    if not name or name == "Equal":
        return Equal()
    if name in SEQUENCE_TRANSFORMS:
        raise NotImplementedError(
            f"batch transform [{name}] is not ported: it comes with the sequential "
            "models (ROADMAP.md, queue 1)")
    raise NotImplementedError(f"transform [{name}] is not implemented")
