"""Isosurface extraction: vectorised marching tetrahedra.

Replaces skimage.measure.marching_cubes in the reference pipeline
(reference executor/executor.py:388). Implemented from scratch (scikit-image
is not in the TPU image): each grid cube that straddles the level set is split
into 6 tetrahedra around the main diagonal; each tetrahedron contributes 1-2
triangles with vertices linearly interpolated on its sign-changing edges.
Marching tetrahedra needs no 256-case table, produces a watertight surface
within the decomposition, and vectorises cleanly:

  1. active-cube prefilter (corner min/max straddle test) — the expensive
     per-tet work only touches the O(n^2) surface shell, not the n^3 volume;
  2. all remaining tets processed as flat numpy arrays;
  3. vertex welding via unique (edge-endpoint-pair) keys;
  4. triangle orientation fixed globally: normal . (outside - inside) > 0,
     so normals point toward positive field values (SDF outside).

API mirrors skimage: marching_cubes(volume, level, spacing, origin) ->
(vertices, faces).

The port's own copy of sdf_representation_tpu/ops/marching.py (host core
only). A torch volume, on the card or not, is copied to the host and
marched here; the on-device packed-wire marcher is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# corner offsets, bit order (x, y, z)
_CORNERS = np.array(
    [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], dtype=np.int64
)
# index of corner (x,y,z) in _CORNERS = x*4 + y*2 + z
# 6-tet decomposition around the 0-7 main diagonal
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)
# tet edges
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# case tables: for each of the 16 inside-bitmasks, triangles as triples of
# tet-edge ids. Orientation is fixed numerically afterwards.
_CASE_TRIS = {
    0b0001: [(0, 1, 2)],                  # corner 0 inside  (edges 0-1,0-2,0-3)
    0b0010: [(0, 3, 4)],                  # corner 1
    0b0100: [(1, 3, 5)],                  # corner 2
    0b1000: [(2, 4, 5)],                  # corner 3
    0b0011: [(1, 2, 4), (1, 4, 3)],       # corners 0,1 -> edges 02,03,12,13
    0b0101: [(0, 2, 5), (0, 5, 3)],       # corners 0,2 -> edges 01,03,12,23
    0b1001: [(0, 1, 5), (0, 5, 4)],       # corners 0,3 -> edges 01,02,13,23
    0b0110: [(0, 1, 5), (0, 5, 4)],       # corners 1,2 -> edges 01,02,23,13
    0b1010: [(0, 2, 5), (0, 5, 3)],       # corners 1,3
    0b1100: [(1, 2, 4), (1, 4, 3)],       # corners 2,3
    0b1110: [(0, 1, 2)],                  # corner 0 outside
    0b1101: [(0, 3, 4)],
    0b1011: [(1, 3, 5)],
    0b0111: [(2, 4, 5)],
}


def _build_flip_table():
    """flip_table[tet_local (0..5), case (0..15), tri_k (0..1)] -> bool.

    The orientation of a case-table triangle relative to the inside->outside
    direction is a combinatorial invariant of (tet parity, case): the
    interpolated vertices slide along fixed edges and can never cross the
    tet, so one canonical evaluation per (tet, case, k) decides the flip for
    every runtime triangle. (Replaces a per-triangle geometric pass that
    cost ~half the extraction time on the single-core relay host.)"""
    table = np.zeros((6, 16, 2), dtype=bool)
    for tet_local in range(6):
        corners = _CORNERS[_TETS[tet_local]].astype(np.float64)  # (4, 3)
        for case_id, tris in _CASE_TRIS.items():
            inside = [(case_id >> i) & 1 for i in range(4)]
            vals = np.where(inside, -1.0, 1.0)
            cent_in = corners[np.asarray(inside, bool)].mean(axis=0)
            cent_out = corners[~np.asarray(inside, bool)].mean(axis=0)
            for k, tri in enumerate(tris):
                pts = []
                for e in tri:
                    a, b = _TET_EDGES[e]
                    t = (0.0 - vals[a]) / (vals[b] - vals[a])
                    pts.append(corners[a] + t * (corners[b] - corners[a]))
                normal = np.cross(pts[1] - pts[0], pts[2] - pts[0])
                table[tet_local, case_id, k] = (
                    float(np.dot(normal, cent_out - cent_in)) < 0
                )
    return table


_FLIP_TABLE = _build_flip_table()


def marching_cubes(
    volume,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a (nx, ny, nz) scalar volume.

    Returns (vertices (V,3) float64 in world coords, faces (F,3) int64),
    faces oriented with normals pointing toward values > level. A torch
    tensor is copied to the host first.
    """
    if hasattr(volume, "detach"):
        volume = volume.detach().cpu().numpy()
    vol = np.asarray(volume, dtype=np.float32)
    level = np.float32(level)
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # ---- 1. active cubes ------------------------------------------------
    # a cube straddles the level set iff its 8-corner count of (val <= level)
    # is in 1..7; the count is separable into three axis passes over uint8,
    # ~4x cheaper than 14 float min/max passes on the single-core relay host
    s = (vol <= level).astype(np.uint8)
    sx = s[: nx - 1] + s[1:]
    sxy = sx[:, : ny - 1] + sx[:, 1:]
    cnt = sxy[:, :, : nz - 1] + sxy[:, :, 1:]
    active = np.argwhere((cnt > 0) & (cnt < 8))  # (A, 3)
    corner_vals = np.stack(
        [
            vol[active[:, 0] + dx, active[:, 1] + dy, active[:, 2] + dz]
            for dx, dy, dz in _CORNERS
        ],
        axis=1,
    )  # (A, 8)
    return _march_core(active, corner_vals, vol.shape, level, spacing, origin)


def _march_core(
    active: np.ndarray,
    corner_vals: np.ndarray,
    shape: Tuple[int, int, int],
    level: float,
    spacing: Tuple[float, float, float],
    origin: Tuple[float, float, float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Host marching over the compacted active-cube shell.

    active: (A, 3) cube base indices; corner_vals: (A, 8) field values at the
    cube corners in _CORNERS order. Everything else (tets, welding,
    orientation) is identical to the dense path — the shell is all it needs.
    """
    nx, ny, nz = shape
    level = np.float32(level)
    if len(active) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # global grid-point ids of the 8 corners of each active cube
    def gid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    corner_ids = np.stack(
        [
            gid(active[:, 0] + dx, active[:, 1] + dy, active[:, 2] + dz)
            for dx, dy, dz in _CORNERS
        ],
        axis=1,
    )  # (A, 8)

    # value lookup for any corner gid (edge endpoints all live on the shell)
    all_gids = corner_ids.reshape(-1)
    uniq_gids, first = np.unique(all_gids, return_index=True)
    uniq_vals = corner_vals.reshape(-1)[first]

    # ---- 2. tets --------------------------------------------------------
    tet_ids = corner_ids[:, _TETS].reshape(-1, 4)  # (A*6, 4) global point ids
    tet_vals = corner_vals[:, _TETS].reshape(-1, 4).astype(np.float32)
    # <= matches the active-cube prefilter (s = vol <= level) and the device
    # path's live-edge predicate; with < a value EXACTLY at the level could
    # make emission disagree with the prefilter/vertex liveness
    inside = tet_vals <= level
    case = (
        inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
    )

    tri_edge_list = []  # (n_tris, 3) tet-edge ids
    tri_tet_idx = []  # (n_tris,) index into tets
    tri_flip_list = []  # per-triangle precomputed orientation flips
    for case_id, tris in _CASE_TRIS.items():
        sel = np.nonzero(case == case_id)[0]
        if len(sel) == 0:
            continue
        tet_local = sel % 6
        for k, tri in enumerate(tris):
            tri_edge_list.append(np.broadcast_to(np.asarray(tri), (len(sel), 3)))
            tri_tet_idx.append(sel)
            tri_flip_list.append(_FLIP_TABLE[tet_local, case_id, k])
    if not tri_edge_list:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tri_edges = np.concatenate(tri_edge_list)  # (Ntri, 3)
    tri_tets = np.concatenate(tri_tet_idx)  # (Ntri,)
    tri_flips = np.concatenate(tri_flip_list)  # (Ntri,)

    # ---- 3. edge vertices + welding ------------------------------------
    # edge endpoints as global point ids
    e_a = tet_ids[tri_tets[:, None], _TET_EDGES[tri_edges][..., 0]]  # (Ntri, 3)
    e_b = tet_ids[tri_tets[:, None], _TET_EDGES[tri_edges][..., 1]]
    lo = np.minimum(e_a, e_b).reshape(-1)
    hi = np.maximum(e_a, e_b).reshape(-1)
    keys = lo * (nx * ny * nz) + hi
    uniq, inv = np.unique(keys, return_inverse=True)
    u_lo = uniq // (nx * ny * nz)
    u_hi = uniq % (nx * ny * nz)

    va = uniq_vals[np.searchsorted(uniq_gids, u_lo)]
    vb = uniq_vals[np.searchsorted(uniq_gids, u_hi)]
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-300, (level - va) / denom, 0.5)
    t = np.clip(t, 0.0, 1.0)

    def unflatten(g):
        return np.stack([g // (ny * nz), (g // nz) % ny, g % nz], axis=1).astype(
            np.float64
        )

    pa, pb = unflatten(u_lo), unflatten(u_hi)
    verts_idx = pa + t.astype(np.float64)[:, None] * (pb - pa)  # index space
    faces = inv.reshape(-1, 3)

    # ---- 4. orientation: precomputed per (tet parity, case) --------------
    faces[tri_flips] = faces[tri_flips][:, ::-1]

    # drop degenerate (zero-area after welding) triangles
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    verts_world = verts_idx * np.asarray(spacing) + np.asarray(origin)
    return verts_world, faces.astype(np.int64)
