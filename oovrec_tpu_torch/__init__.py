"""oovrec_tpu_torch — the PyTorch/CUDA port of `oovrec_tpu` for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths. It imports
torch and numpy only: never JAX, flax, pandas, PyYAML or anything of
`oovrec_tpu`; what it needs of the JAX package's numpy modules it keeps in
its own copy. Every Pallas kernel of the JAX package on a ported path is a
hand-written CUDA kernel under `csrc/`, built with `nvcc` at first use.
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; CUDA requested and absent raises.
"""

__version__ = "0.1.0"
