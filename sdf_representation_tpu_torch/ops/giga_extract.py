"""Slab-streamed field -> mesh extraction past single-pass limits —
counterpart of sdf_representation_tpu/ops/giga_extract.py.

The device marcher (ops/marching_device.py) names a vertex by its slot
``gid*7 + dir`` in int32 space and holds at most 2^24 vertices a pass:
~645^3 grid points. This module lifts both caps by tiling the grid into
x-slabs: each slab is evaluated and marched on its device within the caps,
and the slab meshes are merged on the host in int64 GLOBAL slot space.
Because a slot names a grid edge (low-corner lattice id + one of 7
directions), vertices on a plane two slabs share get identical global slots
from both and dedup exactly: merging is an ``np.unique``, not a weld, and
the topology equals a single-pass extraction's. Cube layers are partitioned
disjointly, so no face is emitted twice.

Field values on shared planes are evaluated twice, once per adjacent slab,
but BITWISE EQUALLY: a slab refines its active blocks through the blocks
entry of csrc/fused_mlp.cu (TPU kernel 3, ``fused_blocks``, counted under
``sparse_blocks``) with their GLOBAL block ids, the same launch arithmetic
as the whole-grid sparse evaluator (ops/sparse_grid.py), so a block's values
do not depend on the slab that evaluates it.

A HashMLP's slabs come from the separable x-slab evaluator
(ops/hash_grid_eval.hash_grid_eval_x_slab, JAX giga_extract.py:212-236):
exact dense values in float32 whatever ``compute_dtype`` says, no activity
selection and no certificate; a plane two slabs share evaluates to the same
bits in both. The JAX module's ``interpret`` and ``mxu_precision`` arguments
are Pallas / XLA switches with no counterpart here.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.hash_mlp import HashMLP
from ..models.implicit_net import ImplicitNet
from ..parallel.mesh import replicate
from . import marching_device
from .fused_mlp import FusedNet, fused_blocks
from .hash_grid_eval import hash_grid_eval_x_slab
from .marching_device import decode_vertices, drop_degenerate
from .sparse_grid import coarse_and_certificate, first_active

_SLOT_DIRS = 7  # edge directions per lattice point in the tet decomposition


def _slab_plan(n: int, slab: int):
    """Disjoint cube-layer partition: slab k covers cube layers
    [k*slab, min((k+1)*slab, n-1)) and needs planes [x0, x1] inclusive."""
    plan = []
    for x0 in range(0, n - 1, slab):
        x1 = min(x0 + slab, n - 1)
        plan.append((x0, x1 - x0 + 1))
    return plan


def default_slab(n: int, block: int = 8, n_devices: int = 1) -> int:
    """Largest block-aligned slab whose plane count fits the int32 slot
    space (with one plane of overlap). With n_devices > 1, shrink
    (block-aligned) until every device owns >= 1 slab — the slot-limited
    slab can yield fewer slabs than devices (1024^3 -> 4 slabs); the merged
    mesh is identical for any slab size (seam-exact)."""
    max_planes = (2**31 - 1) // (_SLOT_DIRS * n * n)
    slab = max(block, ((max_planes - 1) // block) * block)
    slab = min(slab, ((n - 1 + block - 1) // block) * block)
    while slab > block and len(_slab_plan(n, slab)) < n_devices:
        slab = max(block, slab - block * max(1, (slab // block) // 4))
    return slab


def _slab_budget(mask, plan, n, block, nxb, tile_blocks):
    """(counts, k_max): the host's exact count of active blocks in each
    slab's block-rows, and the one block budget every slab's launch shares
    (the largest count, rounded up to ``tile_blocks``)."""
    nb = n // block
    cum = np.concatenate([[0], np.cumsum(mask.cpu().numpy().reshape(nb, nb * nb).sum(1))])
    counts = [int(cum[min(x0 // block + nxb, nb)] - cum[x0 // block]) for x0, _ in plan]
    k_max = max(tile_blocks, -(-max(counts) // tile_blocks) * tile_blocks)
    return counts, k_max


def _slab_blocks(mask, xb0, nxb, nb, k_max):
    """(ids (k_max,) int32, count (1,) int32): the active blocks of
    block-rows [xb0, xb0 + nxb) by GLOBAL id, as ``first_active`` gives
    them; the blocks entry's inputs for that slab."""
    nb2 = nb * nb
    inslab = torch.zeros_like(mask)
    inslab[xb0 * nb2:min(xb0 + nxb, nb) * nb2] = True
    return first_active(mask & inslab, k_max)


def _refine_slab(net, coarse, mask, xb0, count, n, block, k_max, nxb):
    """The (nxb*block, n, n) volume of block-rows [xb0, xb0 + nxb): the
    coarse fill (padded past the grid's far edge with 3.0) with the
    ``count`` active blocks of those rows refined in place. ``count`` is the
    host's count of those blocks (the scatter writes exactly them, each
    once)."""
    nb = n // block
    nb2 = nb * nb
    pts = block ** 3
    lo, hi = xb0 * nb2, min(xb0 + nxb, nb) * nb2
    ids, count_d = _slab_blocks(mask, xb0, nxb, nb, k_max)
    vals = fused_blocks(net, ids, count_d, n, block)  # global ids: seam-exact
    slab_coarse = coarse[lo:hi]
    if hi - lo < nxb * nb2:
        slab_coarse = torch.cat([slab_coarse, slab_coarse.new_full((nxb * nb2 - (hi - lo),), 3.0)])
    vol_blocked = slab_coarse[:, None].expand(nxb * nb2, pts).contiguous()
    vol_blocked[ids[:count].long() - lo] = vals[:count]
    return (vol_blocked.view(nxb, nb, nb, block, block, block)
            .permute(0, 3, 1, 4, 2, 5).reshape(nxb * block, n, n))


def extract_mesh_giga(
    model: Optional[torch.nn.Module],
    n: int,
    *,
    level: float = 0.0,
    slab: Optional[int] = None,
    block: int = 8,
    safety: float = 1.5,
    eps: float = 0.01,
    tile_blocks: int = 2,
    compute_dtype=torch.bfloat16,
    wire: str = "packed",
    on_violation: str = "error",
    vol_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
    spacing: Optional[float] = None,
    origin: float = -1.0,
    devices=None,
    stages: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` set of the field on the n^3 grid in [-1,1]^3,
    slab by slab. Returns (vertices (V, 3) float64 world coords, faces
    (T, 3) int64): the contract of ops/marching_device.marching_cubes_device
    without its ~645^3 grid or 2^24-vertex caps.

    vol_fn(x0, sx) -> (sx, n, n) field values on planes [x0, x0+sx) may be
    supplied to extract from any field (a tensor is marched on its own
    device, a numpy array on the CPU). By default a HashMLP is evaluated by
    the separable x-slab evaluator (module docstring) and an ImplicitNet by
    the sparse evaluator: one global coarse sweep and
    certificate (ops/sparse_grid.coarse_and_certificate), then per slab one
    blocks-entry launch over the slab's active blocks, in
    ``compute_dtype``; ``tile_blocks`` rounds the launches' shared block
    budget, the largest slab's active count.

    on_violation: response to a certificate violation (see
    ops/sparse_grid.sparse_grid_eval): "error" (default — there is no cheap
    dense fallback at giga scale), "warn", or "dense" (refine EVERY block
    of every slab: dense-eval cost, bounded memory).

    devices: a sequence of torch devices as parallel/mesh.py makes them
    (entries may repeat). The net, coarse field and mask are copied once
    per distinct device; slabs go round-robin over the entries, and results
    drain in slab order, so the merged mesh is identical for any device
    list. Default evaluator only (ignored when vol_fn is supplied).

    stages: a dict that receives the host-clock seconds of "evaluate" (the
    coarse sweep, its certificate and the slab budget), "march" (the slab
    loop but the decode: the device marches and wire copies, the time they
    wait for a slab's evaluation, the host merge) and "decode" (the packed
    wire's host rebuild, summed over the slabs).
    """
    if n % block:
        raise ValueError(f"n={n} must be divisible by block={block}")
    if slab is None:
        slab = default_slab(n, block, 1 if devices is None else len(devices))
    if slab % block:
        raise ValueError(f"slab={slab} must be divisible by block={block}")
    if (slab + 1) * n * n * _SLOT_DIRS >= 2**31:
        raise ValueError(
            f"slab={slab} planes exceed the per-dispatch int32 slot space"
        )
    if on_violation not in ("dense", "error", "warn"):
        raise ValueError(f"on_violation={on_violation!r}")
    if wire not in ("exact", "packed"):
        raise ValueError(f"wire={wire!r}")
    if devices is not None and len(devices) == 0:
        devices = None

    t_start = time.perf_counter()
    nxb = slab // block + 1  # +1: the shared plane lives in the next row
    plan = _slab_plan(n, slab)
    internal_eval = vol_fn is None
    if internal_eval:
        entries = [next(model.parameters()).device] if devices is None else list(devices)
    if internal_eval and isinstance(model, HashMLP):
        replicas = {}
        for dev in entries:
            dev = torch.device(dev)
            if dev not in replicas:
                same = dev == next(model.parameters()).device
                replicas[dev] = model if same else copy.deepcopy(model).to(dev)
        hash_repl = [replicas[torch.device(dev)] for dev in entries]

        def vol_fn(x0, sx, i):
            """Slab i on mesh entry i % len(entries), in float32."""
            return hash_grid_eval_x_slab(hash_repl[i % len(hash_repl)], x0, sx, n)
    elif internal_eval:
        if not isinstance(model, ImplicitNet):
            raise ValueError(
                "default slab evaluator requires an ImplicitNet or a HashMLP; pass "
                "vol_fn for other fields"
            )
        coarse, mask, viol = coarse_and_certificate(model, n, block, float(safety), float(eps),
                                                    float(level))
        viol = int(viol)
        if viol > 0:
            msg = (
                f"extract_mesh_giga certificate: {viol} adjacent "
                f"inactive block pair(s) disagree in center sign at n={n} "
                f"(safety={safety}) — the sparse sweep would miss surface"
            )
            if on_violation == "error":
                raise ValueError(msg)
            print(f"[giga_extract] {msg}; "
                  + ("refining ALL blocks" if on_violation == "dense"
                     else "proceeding (on_violation='warn')"), flush=True)
            if on_violation == "dense":
                mask = torch.ones_like(mask)
        counts, k_max = _slab_budget(mask, plan, n, block, nxb, tile_blocks)

        layers = model.effective_layers()
        flat = [t.detach() for pair in layers for t in pair] + [coarse, mask]
        nets: dict = {}
        repl = []
        for dev, copies in zip(entries, replicate(flat, entries)):
            dev = torch.device(dev)
            if dev not in nets:
                nets[dev] = FusedNet(model, compute_dtype,
                                     layers=list(zip(copies[0:-2:2], copies[1:-2:2])))
            repl.append((nets[dev], copies[-2], copies[-1]))

        def vol_fn(x0, sx, i):
            """Slab i on mesh entry i % len(entries)."""
            net, coarse_d, mask_d = repl[i % len(repl)]
            with torch.no_grad():
                vol = _refine_slab(net, coarse_d, mask_d, x0 // block, counts[i], n, block,
                                   k_max, nxb)
            return vol[:sx]
    t_eval = time.perf_counter() - t_start

    # each slab's march splits into a device half, which ends with its
    # wire's copy to the host (the device is then idle), and a host half
    # (the packed wire's decode)
    if wire == "packed":
        def device_half(vol_slab):
            return marching_device.packed_wire(vol_slab, level), tuple(vol_slab.shape)

        def host_half(half):
            return marching_device.unpack_wire(*half)
    else:
        def device_half(vol_slab):
            return marching_device.marching_tets_device(vol_slab, level)

        def host_half(half):
            return half

    def _vol(i):
        vol_slab = vol_fn(*plan[i], i) if internal_eval else vol_fn(*plan[i])
        if not isinstance(vol_slab, torch.Tensor):
            vol_slab = torch.as_tensor(np.asarray(vol_slab, dtype=np.float32))
        return vol_slab

    # once slab i's device half is done, the evaluations of the next `depth`
    # slabs (`depth`: the distinct devices) are queued before the host
    # decodes slab i, so the devices evaluate while the host decodes (a card
    # listed k times gains nothing from a deeper queue: its march would wait
    # behind the queued evaluations); results drain in slab order, and a
    # slab's volume is released as soon as its wire is on the host, so at
    # most `depth` slab volumes are resident
    depth = len({torch.device(d) for d in entries}) if internal_eval else 1
    pending = {i: _vol(i) for i in range(min(depth, len(plan)))}
    slots_all, t_all, faces_all = [], [], []
    v_off = 0
    decode_s = 0.0
    for i, (x0, sx) in enumerate(plan):
        try:
            half = device_half(pending.pop(i))
        except ValueError as exc:
            if "packed core-word budget" not in str(exc) or slab <= block:
                raise
            # one slab overflowed the per-pass 2^24-vertex cap (a
            # pathologically dense surface): halve the slabs and redo; the
            # merged result does not depend on the slab size
            half_slab = max(block, (slab // 2) // block * block)
            print(f"[giga_extract] slab of {sx} planes overflowed the "
                  f"2^24-vertex dispatch cap; retrying with slab={half_slab}",
                  flush=True)
            pending.clear()
            return extract_mesh_giga(
                model, n, level=level, slab=half_slab, block=block,
                safety=safety, eps=eps, tile_blocks=tile_blocks,
                compute_dtype=compute_dtype, wire=wire,
                on_violation=on_violation,
                vol_fn=None if internal_eval else vol_fn,
                spacing=spacing, origin=origin, devices=devices, stages=stages,
            )
        for j in range(i + 1, min(i + 1 + depth, len(plan))):
            if j not in pending:
                pending[j] = _vol(j)
        t0 = time.perf_counter()
        vslots, t, faces = host_half(half)
        decode_s += time.perf_counter() - t0 if wire == "packed" else 0.0
        del half
        slots_all.append(
            np.asarray(vslots, np.int64) + np.int64(x0) * n * n * _SLOT_DIRS
        )
        t_all.append(np.asarray(t, np.float64))
        faces_all.append(np.asarray(faces, np.int64) + v_off)
        v_off += len(vslots)

    if v_off == 0:
        verts, faces = np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    else:
        slots = np.concatenate(slots_all)
        t = np.concatenate(t_all)
        faces = np.concatenate(faces_all)
        # merge: shared-plane vertices carry identical global slots (and
        # identical t — same field bits on both sides); np.unique dedups them
        uniq, first, inv = np.unique(slots, return_index=True,
                                     return_inverse=True)
        faces = drop_degenerate(inv.reshape(-1)[faces])
        s = 2.0 / (n - 1) if spacing is None else float(spacing)
        verts = decode_vertices(uniq, t[first], (n, n, n), (s, s, s), (origin,) * 3)
    if stages is not None:
        stages.update(evaluate=t_eval, march=time.perf_counter() - t_start - t_eval - decode_s,
                      decode=decode_s)
    return verts, faces
