"""The gathers' backward (`csrc/embed_grad.cu`) in the pairwise training
cell: the bytes of its calls over their device time."""

from benchmark.harness.readers import gather_bwd_roofline as read  # noqa: F401
