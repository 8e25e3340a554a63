"""Decision-tree recommenders (`oovrec_tpu/models/exlib/__init__.py`).
Not registered with the model registry, as in the JAX package."""

from oovrec_tpu_torch.models.exlib.decision_tree import LightGBMModel, XGBoostModel

__all__ = ["XGBoostModel", "LightGBMModel"]
