"""HashMLP dense-grid evaluation by separable interpolation — counterpart of
sdf_representation_tpu/ops/hash_grid_eval.py.

On an axis-aligned grid the trilinear weights factor per axis, so a level's
features are

  feat[i,j,k] = sum_{a,b,c} Wx[i,a] Wy[j,b] Wz[k,c] V[a,b,c]

with V the level's (res+1)^3 corner volume (dense levels: a reshape of the
table; hashed levels: the table gathered at the lattice's hashes) and each W
an (n, res+1) two-banded matrix. One gather of (res+1)^3 rows per level and
three contractions replace the 8 x L gathers per point of the pointwise
encoder; the small MLP then runs on the concatenated features. The
contractions are torch einsums in full float32 (TF32 off for the call), as
the JAX package leaves them to XLA: no hand-written kernel.

The banded weights are built with the pointwise encoder's exact float32
arithmetic (x01 clip, pos = x01*res, floor, frac), so the values match
``HashMLP.forward`` on the same coordinates to float32 rounding.

Grid convention: linspace(-1, 1, n) per axis, 'ij' indexing, coordinates
-1 + step*i in float32.
"""

from __future__ import annotations

import torch

from ..models.hash_mlp import HashMLP, hash_index
from ..utils.device import matmul_precision


def _level_volume(model: HashMLP, level: int, res: int) -> torch.Tensor:
    """One level's (res+1, res+1, res+1, F) corner volume."""
    R = res + 1
    table = model.tables[level]
    if R ** 3 <= model.table_size:
        return table[: R ** 3].reshape(R, R, R, model.n_features)
    r = torch.arange(R, dtype=torch.int64, device=table.device)
    h = hash_index(r[:, None, None], r[None, :, None], r[None, None, :], model.table_size)
    return table[h.reshape(-1)].reshape(R, R, R, model.n_features)


def _axis(n: int, device) -> torch.Tensor:
    """linspace(-1, 1, n) as -1 + step*i in float32 (no fused multiply-add)."""
    step = torch.tensor(2.0 / (n - 1), dtype=torch.float32, device=device)
    return -1.0 + step * torch.arange(n, dtype=torch.float32, device=device)


def _axis_weights(n: int, res: int, device) -> torch.Tensor:
    """(n, res+1) banded interpolation matrix of the axis coordinates, with
    the pointwise encoder's float32 arithmetic."""
    x01 = torch.clamp((_axis(n, device) + 1.0) * 0.5, 0.0, 1.0)
    pos = x01 * res
    p0 = torch.floor(pos).long()
    frac = pos - p0.float()
    W = torch.zeros(n, res + 1, dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    # frac == 0 wherever p0 == res, so the clipped second corner adds zero
    W.index_put_((rows, torch.clamp(p0, 0, res)), 1.0 - frac, accumulate=True)
    W.index_put_((rows, torch.clamp(p0 + 1, 0, res)), frac, accumulate=True)
    return W


def _head(model: HashMLP, feats, coords) -> torch.Tensor:
    """The MLP on the concatenated level features (+ coordinates), each of
    shape (..., F) / (..., 1): (...) values."""
    shape = feats[0].shape[:-1]
    if model.include_xyz:
        feats = feats + [c.expand(*shape, 1) for c in coords]
    h = torch.cat(feats, dim=-1).reshape(-1, sum(f.shape[-1] for f in feats))
    for i, layer in enumerate(model.mlp):
        h = layer(h)
        if i < len(model.mlp) - 1:
            h = torch.relu(h)
    return h[..., 0].reshape(shape)


def _slab(model: HashMLP, z0: int, n: int, slab_d: int) -> torch.Tensor:
    """The (n, n, slab_d) slab from z index z0."""
    device = model.tables.device
    feats = []
    for level in range(model.n_levels):
        res = model.level_resolution(level)
        V = _level_volume(model, level, res)
        Wx = _axis_weights(n, res, device)
        Wz = Wx[z0:z0 + slab_d]
        # z first (shrinks the volume to the slab), then y, then x
        t = torch.einsum("kc,abcf->abkf", Wz, V)
        t = torch.einsum("jb,abkf->ajkf", Wx, t)
        feats.append(torch.einsum("ia,ajkf->ijkf", Wx, t))
    ax = _axis(n, device)
    coords = (ax[:, None, None, None], ax[None, :, None, None],
              ax[z0:z0 + slab_d][None, None, :, None])
    return _head(model, feats, coords)


def _x_sub(model: HashMLP, x0: int, n: int, sub: int) -> torch.Tensor:
    """The (sub, n, n) x-slab from plane x0. The slab axis contracts first,
    so the intermediates stay (sub, n, R, F)-sized."""
    device = model.tables.device
    feats = []
    for level in range(model.n_levels):
        res = model.level_resolution(level)
        V = _level_volume(model, level, res)
        W = _axis_weights(n, res, device)
        t = torch.einsum("ia,abcf->ibcf", W[x0:x0 + sub], V)  # (sub, R, R, F)
        t = torch.einsum("jb,ibcf->ijcf", W, t)  # (sub, n, R, F)
        feats.append(torch.einsum("kc,ijcf->ijkf", W, t))  # (sub, n, n, F)
    ax = _axis(n, device)
    coords = (ax[x0:x0 + sub][:, None, None, None], ax[None, :, None, None],
              ax[None, None, :, None])
    return _head(model, feats, coords)


def hash_grid_eval_x_slab(model: HashMLP, x0: int, sx: int, n: int, sub: int = 8) -> torch.Tensor:
    """(sx, n, n) float32 field values on planes [x0, x0 + sx) on the
    model's device: the giga extractor's evaluator for HashMLP fields.

    Planes are evaluated ``sub`` at a time in calls of one shape, and each
    plane always by the same call whichever slab asks for it: the calls
    start on multiples of ``sub`` across the whole grid (the last one backed
    up to n - sub). A plane two slabs share therefore has the same bits in
    both, on any device: the JAX module starts its calls at the slab's own
    x0 and relies on each plane's contraction being independent of its row,
    which cuBLAS does not promise (on the H100 the shared planes differed in
    their last bits). The extractor's slabs start on block multiples, so
    with sub = 8 no plane outside the slab is evaluated."""
    sub = min(sub, n)

    def call_start(plane: int) -> int:
        return min(plane // sub * sub, n - sub)

    parts = []
    plane = x0
    with torch.no_grad(), matmul_precision("highest"):
        while plane < x0 + sx:
            start = call_start(plane)
            stop = min(start + sub, x0 + sx)
            parts.append(_x_sub(model, start, n, sub)[plane - start:stop - start])
            plane = stop
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def hash_grid_eval(model: HashMLP, n: int, slab_d: int = 32) -> torch.Tensor:
    """The HashMLP on the dense n^3 grid in [-1, 1]^3: an (n, n, n) float32
    tensor on the model's device, equal to ``model(points)`` on the same
    coordinates to float32 rounding. The z axis goes in ``slab_d``-deep
    slabs of one shape (the tail slab backs up) to bound the features'
    memory."""
    slab_d = min(slab_d, n)
    starts = list(range(0, n - slab_d + 1, slab_d))
    if starts[-1] + slab_d < n:
        starts.append(n - slab_d)
    keep = []
    with torch.no_grad(), matmul_precision("highest"):
        for prev, z0 in zip([None] + starts, starts):
            part = _slab(model, z0, n, slab_d)
            overlap = 0 if prev is None else prev + slab_d - z0
            keep.append(part[:, :, overlap:])
    return keep[0] if len(keep) == 1 else torch.cat(keep, dim=2)
