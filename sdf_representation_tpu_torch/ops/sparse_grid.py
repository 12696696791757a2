"""Hierarchical (coarse -> refine) sparse dense-grid SDF evaluation.

Counterpart of sdf_representation_tpu/ops/sparse_grid.py. Only cells that
straddle the zero level set matter for extraction, so:

  1. **Coarse sweep**: the field is evaluated at the centre of every
     ``block``^3 tile of the n^3 grid with the plain f32 forward (torch
     matmuls with TF32 off, as the JAX package leaves it to XLA).
  2. **Selection**: a tile is active when |f(centre) - level| <= tau_b, the
     adaptive Lipschitz margin of ``adaptive_threshold``; a certificate
     counts adjacent inactive tiles whose centres straddle the level.
  3. **Refinement**: the fused kernel evaluates the block^3 points of every
     active tile (``fused_mlp.fused_blocks``); ids and the live count stay
     on the device, tiles past the count exit at once. Coordinates use the
     dense kernel's arithmetic, so refined values equal ``fused_grid_eval``
     bit for bit. Inactive tiles take their centre value (correct sign).

Grid convention: linspace(-1, 1, n), 'ij' indexing, flat = x*n^2 + y*n + z.
"""

from __future__ import annotations

import math

import torch

from .fused_mlp import FusedNet, fused_blocks, fused_grid_eval

# settled active-block budgets per (architecture, shape) key
_KMAX_CACHE: dict = {}


def active_threshold(n: int, block: int, safety: float, eps: float) -> float:
    """|f(center)| bound below which a block might touch a zero crossing
    (the unit-Lipschitz floor of ``adaptive_threshold``)."""
    s = 2.0 / (n - 1)
    return safety * s * math.sqrt(3.0) * (block + 1) / 2.0 + eps


def adaptive_threshold(coarse: torch.Tensor, n: int, block: int, safety: float,
                       eps: float) -> torch.Tensor:
    """Per-block activity threshold tau_b, (nb^3,) f32:
    safety * max(1, L_est) * r + eps with r = s*sqrt(3)*(block+1)/2 and
    L_est the largest face-neighbour centre slope |f(a)-f(b)|/(block*s)
    around the block, dilated by one block (sparse_grid.py:69-123 of the
    JAX package derives it)."""
    nb = n // block
    s = 2.0 / (n - 1)
    r = s * math.sqrt(3.0) * (block + 1) / 2.0
    c3 = coarse.reshape(nb, nb, nb)
    l3 = torch.zeros((nb, nb, nb), dtype=torch.float32, device=coarse.device)
    inv = 1.0 / (block * s)
    for ax in range(3):
        d = torch.diff(c3, dim=ax).abs() * inv
        lo = [0, 0] * 3
        hi = [0, 0] * 3
        # F.pad order is last axis first: (z_lo, z_hi, y_lo, y_hi, x_lo, x_hi)
        lo[2 * (2 - ax)] = 1
        hi[2 * (2 - ax) + 1] = 1
        l3 = torch.maximum(l3, torch.nn.functional.pad(d, lo))
        l3 = torch.maximum(l3, torch.nn.functional.pad(d, hi))
    dil = l3.clone()
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        dil[tuple(lo)] = torch.maximum(dil[tuple(lo)], l3[tuple(hi)])
        dil[tuple(hi)] = torch.maximum(dil[tuple(hi)], l3[tuple(lo)])
    tau = safety * torch.clamp_min(dil, 1.0) * r + eps
    return tau.reshape(-1)


def certificate_violations(coarse: torch.Tensor, mask: torch.Tensor, nb: int,
                           level: float = 0.0) -> torch.Tensor:
    """Count adjacent INACTIVE block pairs whose centres straddle the level
    (each proves a crossing the selection skipped); 0-d int64 tensor."""
    c3 = (coarse <= level).reshape(nb, nb, nb)
    i3 = torch.logical_not(mask).reshape(nb, nb, nb)
    viol = torch.zeros((), dtype=torch.int64, device=coarse.device)
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        bad = (c3[tuple(lo)] != c3[tuple(hi)]) & i3[tuple(lo)] & i3[tuple(hi)]
        viol = viol + bad.sum()
    return viol


def block_centers(n: int, block: int, start: int, stop: int, device) -> torch.Tensor:
    """(stop - start, 3) centres of the flat block ids [start, stop) of the
    (n/block)^3 blocks. Raises where TF32 matmuls are on for a card: the
    coarse sweep over them must run in full f32."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the coarse sweep must run in full f32")
    nb = n // block
    s = 2.0 / (n - 1)
    flat = torch.arange(start, stop, dtype=torch.int64, device=device)
    half = (block - 1) / 2.0
    idx = torch.stack([flat // (nb * nb), (flat // nb) % nb, flat % nb], dim=-1)
    return -1.0 + s * (idx.float() * block + half)


def coarse_and_certificate(model, n: int, block: int, safety: float, eps: float,
                           level: float = 0.0):
    """Coarse centre sweep, activity mask and certificate count."""
    nb = n // block
    centers = block_centers(n, block, 0, nb ** 3, next(model.parameters()).device)
    with torch.no_grad():
        coarse = model(centers).float()
    tau = adaptive_threshold(coarse, n, block, safety, eps)
    mask = (coarse - level).abs() <= tau
    return coarse, mask, certificate_violations(coarse, mask, nb, level)


def first_active(mask: torch.Tensor, k_max: int):
    """(ids (k_max,) int32, count (1,) int32): the first k_max active block
    ids in order (zeros after them) and the number of active blocks, both on
    the mask's device, without a host sync."""
    count = mask.sum(dtype=torch.int32).reshape(1)
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    slot = torch.where(mask & (pos < k_max), pos, k_max)
    ids = torch.zeros(k_max + 1, dtype=torch.int32, device=mask.device)
    ids.scatter_(0, slot, torch.arange(mask.numel(), dtype=torch.int32, device=mask.device))
    return ids[:k_max], count


def _sparse_pass(model, net, n, block, k_max, safety, eps, level):
    nb = n // block
    nb3 = nb ** 3
    coarse, mask, viol = coarse_and_certificate(model, n, block, safety, eps, level)
    ids, count = first_active(mask, k_max)
    # the refinement (the JAX package's refine_blocks)
    vals = fused_blocks(net, ids, count, n, block)
    # coarse fill + scatter of the refined rows; rows past the live count go
    # to a spare row nb3 and are dropped
    valid = torch.arange(k_max, device=coarse.device) < count
    rows = torch.where(valid, ids.long(), nb3)
    vol_blocked = coarse[:, None].expand(nb3, block ** 3)
    vol_blocked = torch.cat([vol_blocked, vol_blocked[:1]]).contiguous()
    vol_blocked[rows] = vals
    vol = (vol_blocked[:nb3].view(nb, nb, nb, block, block, block)
           .permute(0, 3, 1, 4, 2, 5).reshape(n, n, n))
    count_host, viol_host = torch.stack([count[0].long(), viol]).tolist()
    return vol, count_host, viol_host


def sparse_grid_eval(
    model,
    n: int,
    block: int = 8,
    k_max_frac: float = 0.1875,
    safety: float = 1.5,
    eps: float = 0.01,
    compute_dtype=torch.bfloat16,
    return_count: bool = False,
    on_violation: str = "dense",
    level: float = 0.0,
):
    """Sparse hierarchical evaluation of the dense n^3 grid: an (n, n, n) f32
    tensor on the model's device equal to ``fused_grid_eval`` bit for bit on
    every active block and holding correct-sign centre values elsewhere.

    When the active count exceeds the budget k_max the pass reruns with a
    larger one, and falls back to dense when over half of the blocks are
    active. ``on_violation`` ("dense", "error", "warn") answers a certificate
    violation: re-evaluate densely, raise ValueError, or only print."""
    if n % block:
        raise ValueError(f"n={n} must be divisible by block={block}")
    if on_violation not in ("dense", "error", "warn"):
        raise ValueError(f"on_violation={on_violation!r}")
    nb3 = (n // block) ** 3
    net = FusedNet(model, compute_dtype)
    tile = 2  # budgets are kept a multiple of the JAX kernel's tile_blocks

    def dense():
        return fused_grid_eval(model, n, compute_dtype=compute_dtype)

    cache_key = (model.arch, n, block, float(safety), float(eps), float(level),
                 str(compute_dtype))
    k_max = _KMAX_CACHE.get(cache_key, max(tile, int(nb3 * k_max_frac)))
    k_max = -(-k_max // tile) * tile

    while True:
        vol, count, viol = _sparse_pass(model, net, n, block, k_max, safety, eps, level)
        if viol > 0:
            msg = (
                f"sparse_grid_eval certificate: {viol} adjacent inactive "
                f"block pair(s) disagree in center sign at n={n}, "
                f"block={block}, safety={safety} — the field's local "
                "Lipschitz exceeds the selection margin and the sparse "
                "sweep WOULD have missed surface"
            )
            if on_violation == "error":
                raise ValueError(msg)
            print(f"[sparse_grid] {msg}; "
                  + ("re-evaluating densely" if on_violation == "dense"
                     else "proceeding (on_violation='warn')"), flush=True)
            if on_violation == "dense":
                vol = dense()
                break
        if count <= k_max:
            _KMAX_CACHE[cache_key] = k_max
            break
        if count > nb3 // 2:
            vol = dense()
            break
        k_max = -(-int(count * 1.25) // tile) * tile
    if return_count:
        return vol, count
    return vol
