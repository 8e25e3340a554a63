"""The benchmark of the PyTorch and CUDA port (`oovrec_tpu_torch`) on the card."""
