"""Kernel 1 (`topk_range_kernel`, `ops/topk_score.py:fused_topk_scores`):
the sum of its launches' bounds over their device time in the trace."""

from benchmark.harness.readers import topk_roofline as read  # noqa: F401
