"""The CTR training step's share of its roofline (CIN, MLP and linear
operations against the float32 peak), over the traced wall a step."""

from benchmark.harness.readers import train_mfu as read  # noqa: F401
