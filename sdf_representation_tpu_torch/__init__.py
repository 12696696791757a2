"""sdf_representation_tpu_torch — the PyTorch + CUDA port of
sdf_representation_tpu for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). Module names mirror the JAX package's. Ported so far: mesh
reconstruction from a checkpoint (``python -m sdf_representation_tpu_torch
cfg.ini`` with ``ppo = True, reconstruct = True``), with hand-written CUDA
kernels for the fused ImplicitNet forward (csrc/fused_mlp.cu).
"""
