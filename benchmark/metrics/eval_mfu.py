"""The evaluation's share of the card's float32 peak: 2·B·N·D operations a
batch over the traced wall a batch."""

from benchmark.harness.readers import eval_mfu as read  # noqa: F401
