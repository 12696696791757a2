"""sdf_representation_tpu_torch — the PyTorch + CUDA port of
sdf_representation_tpu for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). Module names mirror the JAX package's. Ported so far: the
``configs/mesh_sdf.ini`` pipeline through ``python -m
sdf_representation_tpu_torch cfg.ini`` — sampling with exact signed-distance
labels, supervised training of the ImplicitNet, the dense-grid accuracy
audit and mesh reconstruction — with hand-written CUDA kernels for the
fused ImplicitNet forward (csrc/fused_mlp.cu) and for the exact-SDF distance
and winding streams (csrc/sdf_streams.cu).
"""
