"""sdf_representation_tpu_torch — the PyTorch + CUDA port of
sdf_representation_tpu for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). Module names mirror the JAX package's. Ported so far, through
``python -m sdf_representation_tpu_torch cfg.ini``: the
``configs/mesh_sdf.ini`` pipeline — sampling with exact signed-distance
labels, supervised training of the ImplicitNet, the dense-grid accuracy
audit and mesh reconstruction — and the eikonal path of
``configs/pointcloud_igr.ini`` — the IGR losses and the point-cloud trainer
— with hand-written CUDA kernels for the fused ImplicitNet forward
(csrc/fused_mlp.cu), the exact-SDF distance and winding streams
(csrc/sdf_streams.cu) and the fused (f, grad_x f) forward with its
params-only backward (csrc/fused_igr.cu).
"""
