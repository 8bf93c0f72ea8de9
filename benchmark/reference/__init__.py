"""The benchmark's plain reference of the training step.

A frozen copy of the port's plain PyTorch code (SMPL, deformer, error-bound
sampler, networks, renderer, losses, pose losses, masked Adam), with the two
hand-written kernels in their plain forms (`nn1.py`, `grid.py`). It imports
nothing of the port, so a later change to the port cannot change what the
port is judged against. `check.py` runs it after the measured window.
"""
