"""The pairwise training cell's share of the traced stretch with no device
activity."""

from benchmark.harness.readers import device_idle as read  # noqa: F401
