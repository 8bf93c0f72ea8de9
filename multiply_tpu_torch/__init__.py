"""PyTorch/CUDA port of multiply_tpu for one NVIDIA H100.

The package mirrors `multiply_tpu`'s module paths so each counterpart is easy
to find. It imports torch, numpy, scipy and yaml only: never jax, flax,
`multiply_tpu`, OpenCV, Pillow or `transformers`. Entry points run on `cuda`
unless the caller passes `device="cpu"`; the two hand-written Hopper kernels
(`ops/knn_cuda.py`, `ops/grid_cuda.py`) and the host JPEG decoder
(`utils/jpeg.py`) build from `csrc/` at first use into `_build/`.
"""

__version__ = "0.1.0"
