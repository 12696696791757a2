"""Mesh reconstruction from a trained field.

Counterpart of sdf_representation_tpu/evaluations/reconstruct.py (reference
executor/executor.py:346-400): grid evaluation -> marching tetrahedra ->
STL. The dispatch is the JAX package's (reconstruct.py:43-95). An
ImplicitNet takes ``choose_route``'s route:

  "giga"    on a card, cubesize % 8 == 0 and cubesize^3 * 7 >= 2^31: the
            slab-streamed extractor (ops/giga_extract.py: the sparse
            evaluator's blocks kernel per slab, the device marcher, the
            packed wire), over every visible card when there are several;
  "sparse"  on a card, cubesize % 8 == 0 and >= 256: the sparse evaluator;
            the volume stays on the card and is marched there over the
            packed wire (ops/marching_device.py);
  "dense"   on a card otherwise: the dense fused evaluator, marched on the
            host;
  "cpu"     a model on the CPU: the module's own f32 forward on the dense
            grid, whatever ``compute_dtype`` says (the JAX package's route
            on a CPU backend), marched on the host.

A HashMLP, on any device, takes "giga" (the extractor's x-slab evaluator,
ops/hash_grid_eval.hash_grid_eval_x_slab) at the giga sizes, else "hash":
the separable evaluator's volume (ops/hash_grid_eval.hash_grid_eval), kept
on the model's device and marched there over the packed wire. The other
families (FeedForwardNetwork, Siren, KAN) take "plain": the module's own
float32 forward on the dense grid (``evaluate_grid``, in chunks of
``chunk`` points, as the JAX package's ``evaluate_grid``) on the model's
device; a card's volume rides the packed wire, a CPU one is marched on the
host.

Not ported yet (ROADMAP.md): the GIF (matplotlib is absent on the card's
machine).
"""

from __future__ import annotations

import os
import time

import torch

from ..geometry.mesh_io import Mesh, save_mesh
from ..models.hash_mlp import HashMLP
from ..models.implicit_net import ImplicitNet
from ..ops import giga_extract
from ..ops.fused_mlp import fused_grid_eval
from ..ops.grid_eval import evaluate_grid
from ..ops.hash_grid_eval import hash_grid_eval
from ..ops.marching import marching_cubes
from ..ops.sparse_grid import sparse_grid_eval

# smallest cubesize that takes the sparse evaluator
SPARSE_MIN_CUBESIZE = 256

# host-clock seconds of each stage of the last reconstruction:
# load_checkpoint, evaluate, march, decode (the packed wire's host rebuild;
# the "sparse" and "giga" routes) and write_stl. A stage that leaves work on
# the card ends with one torch.cuda.synchronize, so that the next stage is
# not booked the card's time. On the "giga" route "evaluate" is the coarse
# sweep, and each slab's evaluation runs while the host decodes the slab
# before it: what of it the decode does not hide is booked under "march".
LAST_STAGE_SECONDS: dict = {}


def _lap(name: str, since: float, device=None) -> float:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    LAST_STAGE_SECONDS[name] = now - since
    return now


def is_giga(cubesize: int) -> bool:
    """Past the single-pass marcher's int32 slot space (and block-aligned)."""
    return cubesize % 8 == 0 and cubesize ** 3 * 7 >= 2 ** 31


def choose_route(cubesize: int, device_kind: str) -> str:
    """The route of an ImplicitNet on a device of kind ``device_kind``
    ("cuda" or "cpu"): "giga", "sparse", "dense" or "cpu" (module
    docstring)."""
    if device_kind == "cpu":
        return "cpu"
    if is_giga(cubesize):
        return "giga"
    if cubesize % 8 == 0 and cubesize >= SPARSE_MIN_CUBESIZE:
        return "sparse"
    return "dense"


def model_route(model, cubesize: int) -> str:
    """The route of any model family (module docstring)."""
    if isinstance(model, HashMLP):
        return "giga" if is_giga(cubesize) else "hash"
    if not isinstance(model, ImplicitNet):
        return "plain"
    return choose_route(cubesize, next(model.parameters()).device.type)


def reconstruct_mesh(model, cubesize: int, compute_dtype=torch.bfloat16,
                     level: float = 0.0, chunk: int = 262144) -> Mesh:
    """Evaluate the field on the cubesize^3 grid in [-1, 1]^3 and extract
    the ``level`` set. spacing = 2/(n-1) and origin -1, so vertices land in
    [-1, 1]^3. ``compute_dtype`` is the ImplicitNet kernels' working type;
    the other families evaluate in float32. ``chunk``: the points per
    forward of the "cpu" and "plain" routes. The stage times land in
    ``LAST_STAGE_SECONDS``."""
    device = next(model.parameters()).device
    route = model_route(model, cubesize)
    spacing = 2.0 / (cubesize - 1)
    t = time.perf_counter()
    stages: dict = {}
    if route == "giga":
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        verts, faces = giga_extract.extract_mesh_giga(
            model, cubesize, level=level, compute_dtype=compute_dtype, wire="packed",
            on_violation="dense", stages=stages,
            devices=tuple(torch.device("cuda", i) for i in range(n_cards)) if n_cards > 1 else None)
        LAST_STAGE_SECONDS.update(stages)
        return Mesh(verts, faces)
    if route == "hash":
        vol = hash_grid_eval(model, cubesize)
    elif route in ("cpu", "plain"):
        vol = evaluate_grid(model, cubesize, chunk=chunk)
        if device.type == "cpu":
            vol = vol.numpy()
    elif route == "sparse":
        vol = sparse_grid_eval(model, cubesize, compute_dtype=compute_dtype, level=level)
    else:
        vol = fused_grid_eval(model, cubesize, compute_dtype=compute_dtype).cpu().numpy()
    t = _lap("evaluate", t, device)
    # a device volume rides the packed wire (sign bits + u16 t): identical
    # topology, vertices within spacing/65535; a numpy one is marched here
    verts, faces = marching_cubes(vol, level=level, spacing=(spacing,) * 3,
                                  origin=(-1.0, -1.0, -1.0), wire="packed", stages=stages)
    _lap("march", t, device)
    if "decode" in stages:
        LAST_STAGE_SECONDS["decode"] = stages["decode"]
        LAST_STAGE_SECONDS["march"] -= stages["decode"]
    return Mesh(verts, faces)


def reconstruct_only(trainer, gif: bool = True, compute_dtype=torch.bfloat16) -> str:
    """Load the newest checkpoint, reconstruct, export the STL (and with
    ``gif`` a rotating GIF beside it, where matplotlib imports; a failure
    to draw it is printed, not raised); returns the STL's path
    (postprocess/reconstructed_epoch{E}.stl). The stage times land in
    ``LAST_STAGE_SECONDS``."""
    c = trainer.config
    LAST_STAGE_SECONDS.clear()
    t = time.perf_counter()
    _, epoch = trainer.load_model(best=False)
    _lap("load_checkpoint", t)
    mesh = reconstruct_mesh(trainer.model, c.cubesize, compute_dtype=compute_dtype,
                            chunk=min(c.ppbatchsize, 262144))
    stl_path = os.path.join(trainer.postprocess_save_path, f"reconstructed_epoch{epoch}.stl")
    if len(mesh.faces) == 0:
        print("reconstruct: empty level set, nothing to export")
        return stl_path
    t = time.perf_counter()
    save_mesh(mesh, stl_path)
    _lap("write_stl", t)
    if gif:
        try:
            from .generate_gif import plot_stl

            plot_stl(stl_path, stl_path.replace(".stl", ".gif"))
        except Exception as exc:
            print(f"GIF generation failed: {exc}")
    return stl_path
