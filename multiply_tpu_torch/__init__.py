"""PyTorch/CUDA port of multiply_tpu for one NVIDIA H100.

The package mirrors `multiply_tpu`'s module paths so each counterpart is easy
to find. It imports torch, numpy and yaml only: never jax, flax or
`multiply_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; the two hand-written Hopper kernels (`ops/knn_cuda.py`,
`ops/grid_cuda.py`) build from `csrc/` at first use into `_build/`.
"""

__version__ = "0.1.0"
