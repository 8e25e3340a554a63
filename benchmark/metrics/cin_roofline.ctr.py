"""Kernels 4 and 5, the CIN stack forward and backward (`csrc/cin_fused.cu`,
`csrc/cin_fused_bwd.cu`): each traced step's bound over their device time."""

from benchmark.harness.readers import cin_roofline as read  # noqa: F401
