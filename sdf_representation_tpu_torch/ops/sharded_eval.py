"""Grid evaluation sharded over a mesh of devices — counterpart of
sdf_representation_tpu/ops/sharded_eval.py.

The JAX package runs one program per device under ``shard_map``; here one
process launches each shard's work on the shard's device and gathers the
results on the mesh's first device (parallel/mesh.py says why it is not
``torch.distributed``: a card may be listed twice, and NCCL would refuse
that). The kernels are those of ops/fused_mlp.py, once per shard:

  ``sharded_grid_eval``         the dense grid: shard d sweeps the d-th
                                contiguous slab of tiles through one
                                ``fused_grid_tiles`` launch from its base
                                tile (TPU kernel 10, _local_sweep_pallas
                                :31-48; counter ``sharded_grid``).
  ``sparse_sharded_grid_eval``  the sparse evaluator: each shard
                                coarse-sweeps its slice of the block
                                centres, the gathered field selects the
                                active blocks, shard d refines the d-th
                                slice of the active list through one
                                ``fused_blocks`` launch (TPU kernel 11, the
                                pallas_call in _sparse_sharded_device :124-263;
                                counter ``sparse_sharded_blocks``), and each
                                shard assembles its x-slab of the volume.

Every grid point goes through the same ``__device__`` routine whatever its
shard, so the dense result equals one ``fused_grid`` launch bit for bit, and
the refined rows equal ``fused_blocks``'s on the same ids. The coarse sweep
is the module's f32 forward over a shard's centres: a matrix product over a
slice may round a centre's last bit differently from one over all of them.

On the CPU the wrappers take their plain versions (``fused_grid_tiles_plain``,
``fused_blocks_plain``); on a card the kernel runs on every shard, or the
call raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..parallel.mesh import gather, get_mesh, replicate
from . import fused_mlp as fm
from .sparse_grid import adaptive_threshold, block_centers, certificate_violations, first_active

# settled active budgets per (architecture, shape, device count) key
_KMAX_CACHE_SHARDED: dict = {}


def _nets(model, mesh, compute_dtype) -> List[fm.FusedNet]:
    """Per mesh entry, the net's fused weights on its device, packed once
    per distinct device."""
    layers = model.effective_layers()
    flat = [t.detach() for pair in layers for t in pair]
    nets: dict = {}
    out = []
    for dev, copies in zip(mesh, replicate(flat, mesh)):
        if dev not in nets:
            nets[dev] = fm.FusedNet(model, compute_dtype, layers=list(zip(copies[0::2], copies[1::2])))
        out.append(nets[dev])
    return out


def slab_tiles(n: int, n_dev: int, tile_p: int) -> int:
    """Kernel tiles (fused_mlp.TILE_P points) per device: the JAX slab plan
    (sharded_eval.py:68-71), n_tiles = round_up(ceil(n^3 / tile_p), n_dev)
    tiles of tile_p points, tiles_local = n_tiles / n_dev per device."""
    if tile_p <= 0 or tile_p % fm.TILE_P:
        raise ValueError(f"tile_p must be a multiple of {fm.TILE_P}, got {tile_p}")
    tiles = -(-n ** 3 // tile_p)
    tiles_local = -(-tiles // n_dev)
    return tiles_local * (tile_p // fm.TILE_P)


def _sharded_grid(model, n: int, mesh, tile_p: int, compute_dtype, tiles) -> torch.Tensor:
    mesh = get_mesh(devices=mesh)
    local = slab_tiles(n, len(mesh), tile_p)
    with torch.no_grad():
        pieces = [tiles(net, n, d * local, local)
                  for d, net in enumerate(_nets(model, mesh, compute_dtype))]
        # pieces past n^3 are dropped (sharded_eval.py:107)
        return gather(pieces, mesh[0])[: n ** 3].reshape(n, n, n)


def sharded_grid_eval(model, n: int, mesh, tile_p: int = 1024,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The field on the dense n^3 grid over linspace(-1, 1, n) with the
    point axis sharded over ``mesh``: (n, n, n) f32 on ``mesh[0]``, equal
    to ``fused_grid_eval`` (sharded_eval.sharded_grid_eval, :56-107)."""
    return _sharded_grid(model, n, mesh, tile_p, compute_dtype, fm.fused_grid_tiles)


def sharded_grid_eval_plain(model, n: int, mesh, tile_p: int = 1024,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``sharded_grid_eval`` through each shard's plain tile function, on
    any device."""
    return _sharded_grid(model, n, mesh, tile_p, compute_dtype, fm.fused_grid_tiles_plain)


def active_slice(ids: torch.Tensor, count: torch.Tensor, d: int,
                 n_dev: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard d's slice of the active list (sharded_eval.py:181-182): ids
    [d k_loc, (d + 1) k_loc) and count_loc = clamp(count - d k_loc, 0,
    k_loc) as a one-element int32 tensor on the ids' device (no host
    sync)."""
    k_loc = ids.shape[0] // n_dev
    count_loc = torch.clamp(count - d * k_loc, 0, k_loc).to(torch.int32)
    return ids[d * k_loc:(d + 1) * k_loc], count_loc


def coarse_slices(model, n: int, block: int, mesh) -> List[torch.Tensor]:
    """Step 1 of _sparse_sharded_device (:144-157): per mesh entry, the
    module's f32 forward at the centres of its contiguous slice of the
    (n/block)^3 blocks, on its device (matrix products in full f32)."""
    mesh = get_mesh(devices=mesh)
    nb3_loc = (n // block) ** 3 // len(mesh)
    names = [name for name, _ in model.named_parameters()]
    out = []
    with torch.no_grad():
        params = replicate([p.detach() for p in model.parameters()], mesh)
        for d, (dev, ps) in enumerate(zip(mesh, params)):
            centers = block_centers(n, block, d * nb3_loc, (d + 1) * nb3_loc, dev)
            out.append(torch.func.functional_call(model, dict(zip(names, ps)), (centers,)).float())
    return out


def _sparse_sharded_pass(model, nets, mesh, n, block, k_max, safety, eps):
    """One pass of _sparse_sharded_device: (vol on mesh[0], count, viol)."""
    n_dev = len(mesh)
    nb = n // block
    nb3_loc = nb ** 3 // n_dev
    pts = block ** 3
    distinct = list(dict.fromkeys(mesh))
    coarse_loc = coarse_slices(model, n, block, mesh)
    with torch.no_grad():
        # 2. selection on the gathered field, once per distinct device
        select = {}
        for dev in distinct:
            coarse = gather(coarse_loc, dev)
            mask = coarse.abs() <= adaptive_threshold(coarse, n, block, safety, eps)
            ids, count = first_active(mask, k_max)
            select[dev] = ids, count, certificate_violations(coarse, mask, nb)
        # 3. shard d refines the d-th slice of the active list
        fine_loc = []
        for d, (dev, net) in enumerate(zip(mesh, nets)):
            ids_loc, count_loc = active_slice(*select[dev][:2], d, n_dev)
            fine_loc.append(fm.fused_blocks(net, ids_loc, count_loc, n, block,
                                            counter="sparse_sharded_blocks"))
        # 4. each shard assembles its x-slab: coarse fill, then the refined
        # rows that fall in it; the rest go to a spare row that is dropped
        fine_all = {dev: gather(fine_loc, dev) for dev in distinct}
        slabs = []
        for d, dev in enumerate(mesh):
            ids, count, _ = select[dev]
            tgt = ids.long() - d * nb3_loc
            live = (torch.arange(k_max, device=dev) < count) & (tgt >= 0) & (tgt < nb3_loc)
            tgt = torch.where(live, tgt, nb3_loc)
            vol = coarse_loc[d][:, None].expand(nb3_loc, pts)
            vol = torch.cat([vol, vol[:1]]).contiguous()
            vol[tgt] = fine_all[dev]
            slabs.append(vol[:nb3_loc].view(nb // n_dev, nb, nb, block, block, block)
                         .permute(0, 3, 1, 4, 2, 5).reshape(n // n_dev, n, n))
        vol = gather(slabs, mesh[0])
        _, count, viol = select[mesh[0]]
        count_host, viol_host = torch.stack([count[0].long(), viol]).tolist()
    return vol, count_host, viol_host


def sparse_sharded_grid_eval(
    model,
    n: int,
    mesh,
    block: int = 8,
    k_max_frac: float = 0.1875,
    safety: float = 1.5,
    eps: float = 0.01,
    tile_blocks: int = 2,
    compute_dtype=torch.bfloat16,
    return_count: bool = False,
    on_violation: str = "dense",
):
    """Sparse hierarchical evaluation with the active blocks sharded over
    ``mesh`` (sharded_eval.sparse_sharded_grid_eval, :266-356): an (n, n, n)
    f32 tensor on ``mesh[0]`` equal to ``fused_grid_eval`` bit for bit on
    every active block, correct-sign centre values elsewhere.
    ``on_violation`` as in ``sparse_grid.sparse_grid_eval``; the dense
    answer (past nb^3 / 2 active blocks, or on a violation) is
    ``sharded_grid_eval``. Requires n % block == 0 and (n / block) %
    len(mesh) == 0; the budget k_max is kept a multiple of tile_blocks *
    len(mesh) and retried at 1.25 x the count when it overflows."""
    mesh = get_mesh(devices=mesh)
    n_dev = len(mesh)
    if n % block:
        raise ValueError(f"n={n} must be divisible by block={block}")
    nb = n // block
    if nb % n_dev:
        raise ValueError(f"block-grid {nb}^3 must split over {n_dev} devices (nb % n_dev == 0)")
    if on_violation not in ("dense", "error", "warn"):
        raise ValueError(f"on_violation={on_violation!r}")
    nb3 = nb ** 3
    quantum = tile_blocks * n_dev
    cache_key = (model.arch, n, block, tile_blocks, float(safety), float(eps),
                 str(compute_dtype), n_dev)
    k_max = _KMAX_CACHE_SHARDED.get(cache_key, max(quantum, int(nb3 * k_max_frac)))
    k_max = -(-k_max // quantum) * quantum

    def dense():
        return sharded_grid_eval(model, n, mesh, compute_dtype=compute_dtype)

    nets = _nets(model, mesh, compute_dtype)
    while True:
        vol, count, viol = _sparse_sharded_pass(model, nets, mesh, n, block, k_max, safety, eps)
        if viol > 0:
            msg = (f"sparse_sharded_grid_eval certificate: {viol} adjacent inactive block "
                   f"pair(s) disagree in center sign at n={n}, block={block}, safety={safety}")
            if on_violation == "error":
                raise ValueError(msg)
            print(f"[sharded_eval] {msg}; "
                  + ("re-evaluating densely" if on_violation == "dense"
                     else "proceeding (on_violation='warn')"), flush=True)
            if on_violation == "dense":
                vol = dense()
                break
        if count <= k_max:
            _KMAX_CACHE_SHARDED[cache_key] = k_max
            break
        if count > nb3 // 2:
            vol = dense()
            break
        k_max = -(-int(count * 1.25) // quantum) * quantum
    if return_count:
        return vol, count
    return vol
