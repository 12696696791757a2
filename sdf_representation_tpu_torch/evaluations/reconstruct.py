"""Mesh reconstruction from a trained field.

Counterpart of sdf_representation_tpu/evaluations/reconstruct.py (reference
executor/executor.py:346-400): grid evaluation through the fused kernels ->
marching tetrahedra on the host -> STL. The dispatch is the JAX package's
for ImplicitNet: on a card the sparse evaluator when ``cubesize`` is a
multiple of 8 and at least 256, the dense fused evaluator otherwise; on the
CPU the module's own f32 forward on the dense grid, whatever
``compute_dtype`` says (the JAX package's route on a CPU backend).

Not ported yet (ROADMAP.md): the slab-streamed giga extractor for grids past
the single-pass index space, the on-device packed-wire marcher, and the GIF
(matplotlib is absent on the card's machine).
"""

from __future__ import annotations

import os
import time

import torch

from ..geometry.mesh_io import Mesh, save_mesh
from ..models.implicit_net import ImplicitNet
from ..ops.fused_mlp import fused_grid_eval
from ..ops.grid_eval import evaluate_grid
from ..ops.marching import marching_cubes
from ..ops.sparse_grid import sparse_grid_eval

# smallest cubesize that takes the sparse evaluator
SPARSE_MIN_CUBESIZE = 256

# host-clock seconds of each stage of the last reconstruction. A stage ends
# where the host waits for it anyway (the volume's copy to the host waits for
# the card), so timing adds no synchronize.
LAST_STAGE_SECONDS: dict = {}


def _lap(name: str, since: float) -> float:
    now = time.perf_counter()
    LAST_STAGE_SECONDS[name] = now - since
    return now


def reconstruct_mesh(model, cubesize: int, compute_dtype=torch.bfloat16,
                     level: float = 0.0) -> Mesh:
    """Evaluate the field on the cubesize^3 grid in [-1, 1]^3 and extract
    the ``level`` set. spacing = 2/(n-1) and origin -1, so vertices land in
    [-1, 1]^3. Records the seconds of "evaluate" (up to the volume on the
    host) and "march" in ``LAST_STAGE_SECONDS``."""
    if not isinstance(model, ImplicitNet):
        raise NotImplementedError(f"{type(model).__name__} reconstruction is not ported yet")
    if cubesize % 8 == 0 and cubesize ** 3 * 7 >= 2 ** 31:
        raise NotImplementedError(
            f"cubesize {cubesize} needs the slab-streamed giga extractor "
            "(ops/giga_extract.py), not ported yet: see ROADMAP.md"
        )
    t = time.perf_counter()
    if next(model.parameters()).device.type == "cpu":
        vol = evaluate_grid(model, cubesize)
    elif cubesize % 8 == 0 and cubesize >= SPARSE_MIN_CUBESIZE:
        vol = sparse_grid_eval(model, cubesize, compute_dtype=compute_dtype, level=level)
    else:
        vol = fused_grid_eval(model, cubesize, compute_dtype=compute_dtype)
    vol = vol.cpu().numpy()
    t = _lap("evaluate", t)
    spacing = 2.0 / (cubesize - 1)
    verts, faces = marching_cubes(vol, level=level, spacing=(spacing,) * 3,
                                  origin=(-1.0, -1.0, -1.0))
    _lap("march", t)
    return Mesh(verts, faces)


def reconstruct_only(trainer, gif: bool = False, compute_dtype=torch.bfloat16) -> str:
    """Load the newest checkpoint, reconstruct, export the STL; returns its
    path (postprocess/reconstructed_epoch{E}.stl). The stage times land in
    ``LAST_STAGE_SECONDS``."""
    if gif:
        raise NotImplementedError(
            "the GIF needs matplotlib, which the card's machine lacks: see ROADMAP.md"
        )
    c = trainer.config
    LAST_STAGE_SECONDS.clear()
    t = time.perf_counter()
    _, epoch = trainer.load_model(best=False)
    _lap("load_checkpoint", t)
    mesh = reconstruct_mesh(trainer.model, c.cubesize, compute_dtype=compute_dtype)
    stl_path = os.path.join(trainer.postprocess_save_path, f"reconstructed_epoch{epoch}.stl")
    if len(mesh.faces) == 0:
        print("reconstruct: empty level set, nothing to export")
        return stl_path
    t = time.perf_counter()
    save_mesh(mesh, stl_path)
    _lap("write_stl", t)
    return stl_path
