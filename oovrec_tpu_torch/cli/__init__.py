"""Command-line entry points: `python -m oovrec_tpu_torch.cli.run`."""
