from oovrec_tpu_torch.eval.collector import Collector, Evaluator, calculate_valid_score
from oovrec_tpu_torch.eval.inductive import InductiveEvaluator
from oovrec_tpu_torch.eval.runner import EvalRunner

__all__ = [
    "Collector", "Evaluator", "EvalRunner", "InductiveEvaluator",
    "calculate_valid_score",
]
