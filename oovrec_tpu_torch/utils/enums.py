"""Framework enums.

Mirrors the taxonomy of the reference framework
(`recbole/utils/enum_type.py:14-100`) so configs and model registries speak
the same language, without inheriting any torch machinery.
"""

from enum import Enum


class ModelType(Enum):
    """Type of a recommender model (drives dataset/dataloader selection)."""

    GENERAL = 1
    SEQUENTIAL = 2
    CONTEXT = 3
    KNOWLEDGE = 4
    TRADITIONAL = 5
    DECISIONTREE = 6


class EvaluatorType(Enum):
    """Whether metrics rank item lists (RANKING) or score values (VALUE)."""

    RANKING = 1
    VALUE = 2


class InputType(Enum):
    """Loss input type of a model."""

    POINTWISE = 1
    PAIRWISE = 2
    LISTWISE = 3


class FeatureType(Enum):
    """Field types of the atomic-file format (`dataset.py:450` semantics)."""

    TOKEN = "token"
    FLOAT = "float"
    TOKEN_SEQ = "token_seq"
    FLOAT_SEQ = "float_seq"


class FeatureSource(Enum):
    """Which atomic file a field comes from."""

    INTERACTION = "inter"
    USER = "user"
    ITEM = "item"
    USER_ID = "user_id"
    ITEM_ID = "item_id"
    KG = "kg"
    NET = "net"
