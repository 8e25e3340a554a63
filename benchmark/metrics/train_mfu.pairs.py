"""The pairwise training step's share of its roofline (dense Adam's bytes
against the bandwidth), over the traced wall a step."""

from benchmark.harness.readers import train_mfu as read  # noqa: F401
