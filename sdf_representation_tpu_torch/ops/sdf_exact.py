"""Exact mesh signed distance + normals — counterpart of
sdf_representation_tpu/ops/sdf_exact.py (the role of igl.signed_distance in
the reference, datagenerator/data_generator.py:880-906).

Every pairwise term of the Eberly closest-point test and of the van
Oosterom-Strackee solid angle decomposes into dot products with the query
point plus per-triangle constants,

    (vi - P) . (vj - P) = vi.vj - P.vi - P.vj + |P|^2
    det(v0-P, v1-P, v2-P) = det(v0,v1,v2) - P . (v0xv1 + v1xv2 + v2xv0)

so the constants are tabulated once on the host (``_triangle_tables``, in
float64, stored float32) and an all-pairs sweep needs only the points and
the tables. On a card the sweep runs through the hand-written CUDA streams
(``ops/sdf_streams.py``); on the CPU through their plain versions. Large
work goes to the culled method (``ops/sdf_culled.py``).

Sign is the generalized winding number: the summed solid angle of all
triangles, > 2 pi => inside. The tile pass picks the winning triangle; a
per-point refinement recomputes its closest point from the direct
(P - closest) difference, so the narrow band carries only coordinate-epsilon
error. The returned normal is the SDF gradient sign * (P - closest)/|.|, or
the winning face's normal for on-surface points. Everything is float32;
``closest_point_on_triangles`` is the float64 test oracle.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span

__all__ = ["signed_distance", "winding_number", "closest_point_on_triangles"]

POINT_CHUNK = 8192  # points per block of the streams


# ---------------------------------------------------------------------------
# Per-triangle precomputation (host, then shipped to the device once)
# ---------------------------------------------------------------------------

def _triangle_tables(vertices: np.ndarray, faces: np.ndarray, tri_chunk: int):
    """Pack per-triangle constants into (C, T, ...) arrays, padded with
    far-away degenerate triangles that cannot win the min or bias the sign."""
    tri = np.asarray(vertices)[np.asarray(faces)].astype(np.float64)  # (F, 3, 3)
    F = len(tri)
    C = max(1, -(-F // tri_chunk))
    pad = C * tri_chunk - F
    if pad:
        far = np.full((pad, 3, 3), 1e9, dtype=np.float64)
        tri = np.concatenate([tri, far], axis=0)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e0, e1 = v1 - v0, v2 - v0
    n = np.cross(e0, e1)
    n_len = np.linalg.norm(n, axis=1, keepdims=True)
    valid = np.zeros(C * tri_chunk, dtype=np.float32)
    valid[:F] = 1.0

    def dots(a, b):
        return np.einsum("ij,ij->i", a, b)

    tables = {
        "v0": v0, "v1": v1, "v2": v2, "E0": e0, "E1": e1,
        "a": dots(e0, e0), "b": dots(e0, e1), "c": dots(e1, e1),
        "e0v0": dots(e0, v0), "e1v0": dots(e1, v0),
        "n00": dots(v0, v0), "n11": dots(v1, v1), "n22": dots(v2, v2),
        "n01": dots(v0, v1), "n12": dots(v1, v2), "n20": dots(v2, v0),
        "d0": dots(v0, np.cross(v1, v2)),
        "K": np.cross(v0, v1) + np.cross(v1, v2) + np.cross(v2, v0),
        "N": n / np.maximum(n_len, 1e-300),
        "valid": valid,
    }
    out = {}
    for k, v in tables.items():
        v32 = np.asarray(v, dtype=np.float32)
        out[k] = v32.reshape(C, tri_chunk, *v32.shape[1:])
    return out, F


# ---------------------------------------------------------------------------
# Eberly point-triangle closest point, elementwise
# ---------------------------------------------------------------------------

def _eberly_st(a, b, c, d, e):
    """Clamped minimiser (s, t) of Q(s,t) = a s^2 + 2b st + c t^2 + 2d s + 2e t.

    a, b, c are per-triangle (broadcastable), d, e per pair. All operations
    are elementwise, so one body serves the (M, T) float32 torch tile, the
    (N,) refinement pass and the (N,) float64 numpy oracle.
    """
    if isinstance(d, torch.Tensor):
        where, maximum = torch.where, torch.clamp_min
        clamp01 = lambda x: torch.clamp(x, 0.0, 1.0)
    else:
        where, maximum = np.where, np.maximum
        clamp01 = lambda x: np.clip(x, 0.0, 1.0)
    eps = 1e-30
    det = maximum(a * c - b * b, eps)
    s = b * e - c * d
    t = b * d - a * e

    inv_a = 1.0 / maximum(a, eps)
    inv_c = 1.0 / maximum(c, eps)
    denom_ac = maximum(a - 2.0 * b + c, eps)

    in_lower = (s + t) <= det
    # region 0
    s0, t0 = s / det, t / det
    # edges
    s_edge_t0 = clamp01(-d * inv_a)        # t = 0 edge
    t_edge_s0 = clamp01(-e * inv_c)        # s = 0 edge
    # region 4 (s<0, t<0)
    r4_s = where(d < 0, s_edge_t0, 0.0)
    r4_t = where(d < 0, 0.0, t_edge_s0)
    # region 3 (s<0, t>=0): s=0, t on edge
    # region 5 (t<0, s>=0): t=0, s on edge
    lower_s = where(s < 0, where(t < 0, r4_s, 0.0), where(t < 0, s_edge_t0, s0))
    lower_t = where(s < 0, where(t < 0, r4_t, t_edge_s0), where(t < 0, 0.0, t0))

    # upper triangle: s + t > det
    # region 2 (s<0): compare (b+d) vs (c+e)
    tmp0_2, tmp1_2 = b + d, c + e
    r2_s = where(tmp1_2 > tmp0_2, clamp01((tmp1_2 - tmp0_2) / denom_ac), 0.0)
    r2_t = where(tmp1_2 > tmp0_2, 1.0 - r2_s, t_edge_s0)
    # region 6 (t<0)
    tmp0_6, tmp1_6 = b + e, a + d
    r6_t = where(tmp1_6 > tmp0_6, clamp01((tmp1_6 - tmp0_6) / denom_ac), 0.0)
    r6_s = where(tmp1_6 > tmp0_6, 1.0 - r6_t, s_edge_t0)
    # region 1 (diagonal edge)
    r1_s = clamp01((c + e - b - d) / denom_ac)
    r1_t = 1.0 - r1_s

    upper_s = where(s < 0, r2_s, where(t < 0, r6_s, r1_s))
    upper_t = where(s < 0, r2_t, where(t < 0, r6_t, r1_t))

    s_out = where(in_lower, lower_s, upper_s)
    t_out = where(in_lower, lower_t, upper_t)
    return s_out, t_out


def closest_point_on_triangles(points: np.ndarray, tri: np.ndarray):
    """Exact (float64) closest point of points[i] on tri[i]: the test
    oracle. points: (N,3), tri: (N,3,3) -> (N,3)."""
    P = np.asarray(points, dtype=np.float64)
    tri = np.asarray(tri, dtype=np.float64)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e0, e1 = v1 - v0, v2 - v0
    dvec = v0 - P
    a = np.einsum("ij,ij->i", e0, e0)
    b = np.einsum("ij,ij->i", e0, e1)
    c = np.einsum("ij,ij->i", e1, e1)
    d = np.einsum("ij,ij->i", e0, dvec)
    e = np.einsum("ij,ij->i", e1, dvec)
    s, t = _eberly_st(a, b, c, d, e)
    return v0 + s[:, None] * e0 + t[:, None] * e1


# ---------------------------------------------------------------------------
# All-pairs tile sweep as plain torch ops (matmul form)
# ---------------------------------------------------------------------------

def _sdf_point_block(P: torch.Tensor, tables, tri_chunk: int):
    """All triangles vs one block of points, with the four dot products as
    float32 matmuls (the JAX package's XLA sweep). P: (M, 3) float32;
    ``tables``: the ``_triangle_tables`` dict as tensors on P's device.

    Returns (min_d2 (M,), best_idx (M,) int32, winding_sum (M,)).
    """
    M = P.shape[0]
    P2 = torch.sum(P * P, dim=1, keepdim=True)
    min_d2 = torch.full((M,), torch.inf, dtype=torch.float32, device=P.device)
    best_idx = torch.zeros((M,), dtype=torch.int32, device=P.device)
    omega = torch.zeros((M,), dtype=torch.float32, device=P.device)
    for cidx in range(tables["a"].shape[0]):
        ch = {k: v[cidx] for k, v in tables.items()}
        Pv0 = P @ ch["v0"].T
        Pv1 = P @ ch["v1"].T
        Pv2 = P @ ch["v2"].T
        d = ch["e0v0"] - (Pv1 - Pv0)
        e = ch["e1v0"] - (Pv2 - Pv0)
        s, t = _eberly_st(ch["a"], ch["b"], ch["c"], d, e)
        d2 = torch.zeros_like(Pv0)
        for k in range(3):
            ck = ch["v0"][:, k] + s * ch["E0"][:, k] + t * ch["E1"][:, k]
            dk = P[:, k:k + 1] - ck
            d2 = d2 + dk * dk
        d2 = torch.where(ch["valid"] > 0, d2, torch.inf)
        local_min = d2.min(dim=1).values
        tri = torch.arange(tri_chunk, dtype=torch.int32, device=P.device)
        local_arg = torch.where(d2 <= local_min[:, None], tri, tri_chunk).min(dim=1).values
        better = local_min < min_d2
        min_d2 = torch.where(better, local_min, min_d2)
        best_idx = torch.where(better, local_arg + cidx * tri_chunk, best_idx)

        PK = P @ ch["K"].T
        la = torch.sqrt(torch.clamp_min(ch["n00"] - 2.0 * Pv0 + P2, 1e-30))
        lb = torch.sqrt(torch.clamp_min(ch["n11"] - 2.0 * Pv1 + P2, 1e-30))
        lc = torch.sqrt(torch.clamp_min(ch["n22"] - 2.0 * Pv2 + P2, 1e-30))
        ab = ch["n01"] - Pv0 - Pv1 + P2
        bc = ch["n12"] - Pv1 - Pv2 + P2
        ca = ch["n20"] - Pv2 - Pv0 + P2
        numer = ch["d0"] - PK
        denom = la * lb * lc + ab * lc + bc * la + ca * lb
        omega = omega + torch.sum(2.0 * torch.atan2(numer, denom) * ch["valid"], dim=1)
    return min_d2, best_idx, omega


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _refine_device(P_cols, tri_flat, best_idx, omega, on_surface_eps: float):
    """Per-point refinement on the winning triangle, on the device: gather ->
    Eberly closest point -> distance / sign / gradient. The direct
    (P - closest) difference keeps float32 error at coordinate epsilon even
    in the narrow band.

    P_cols: 3 (N,) tensors; tri_flat: (9F,) flattened triangles [v0x v0y v0z
    v1x ... v2z] per face. Returns (sdf (N,), grads: 3 (N,) tensors)."""
    px, py, pz = P_cols
    base = best_idx.long() * 9

    def g(k):
        return tri_flat[base + k]

    v0 = (g(0), g(1), g(2))
    v1 = (g(3), g(4), g(5))
    v2 = (g(6), g(7), g(8))
    e0 = tuple(v1[k] - v0[k] for k in range(3))
    e1 = tuple(v2[k] - v0[k] for k in range(3))
    dvec = (v0[0] - px, v0[1] - py, v0[2] - pz)

    dot = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    s, t = _eberly_st(dot(e0, e0), dot(e0, e1), dot(e1, e1), dot(e0, dvec), dot(e1, dvec))
    closest = tuple(v0[k] + s * e0[k] + t * e1[k] for k in range(3))
    diff = (px - closest[0], py - closest[1], pz - closest[2])
    dist = torch.sqrt(torch.clamp_min(dot(diff, diff), 0.0))
    sign = torch.where(omega > (2.0 * math.pi), -1.0, 1.0)
    sdf = sign * dist

    # face normal (cross product, componentwise)
    nx = e0[1] * e1[2] - e0[2] * e1[1]
    ny = e0[2] * e1[0] - e0[0] * e1[2]
    nz = e0[0] * e1[1] - e0[1] * e1[0]
    nlen = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-30)
    inv_d = sign / torch.clamp_min(dist, 1e-30)
    on_surf = dist <= on_surface_eps
    grads = tuple(
        torch.where(on_surf, nc / nlen, dc * inv_d)
        for nc, dc in ((nx, diff[0]), (ny, diff[1]), (nz, diff[2]))
    )
    return sdf, grads


def _mesh_arrays(mesh_or_vertices, faces):
    if hasattr(mesh_or_vertices, "vertices") and hasattr(mesh_or_vertices, "faces"):
        return mesh_or_vertices.vertices, mesh_or_vertices.faces
    if faces is None:
        raise ValueError("faces are needed beside bare vertices")
    return np.asarray(mesh_or_vertices), np.asarray(faces)


def _point_blocks(points, point_chunk: Optional[int], device) -> Tuple[torch.Tensor, int, int]:
    """The (N, 3) points as zero-padded (n_blocks, M, 3) float32 blocks on
    ``device``; returns (blocks, N, M)."""
    pts = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    N = pts.shape[0]
    M = point_chunk or min(POINT_CHUNK, -(-N // 256) * 256)
    n_blocks = -(-N // M)
    blocks = torch.zeros((n_blocks * M, 3), dtype=torch.float32, device=device)
    blocks[:N] = pts
    return blocks.reshape(n_blocks, M, 3), N, M


def signed_distance(
    points,
    mesh_or_vertices,
    faces: Optional[np.ndarray] = None,
    *,
    return_normals: bool = True,
    point_chunk: Optional[int] = None,
    tri_chunk: int = 1024,
    on_surface_eps: float = 1e-6,
    return_device: bool = False,
    method: str = "auto",
    device=None,
    devices=None,
):
    """Signed distance (negative inside) and SDF-gradient normals of (N, 3)
    points (numpy or tensor) against a Mesh or (vertices, faces).

    ``device``: None runs on the card (and raises without one) through the
    CUDA streams; "cpu" runs their plain PyTorch versions. There is no
    fallback from one to the other.

    method: "dense" = all-pairs O(N*F), exact distance and exact winding
    sign; "culled" = ops/sdf_culled.signed_distance_culled (chunk culling,
    exact distances, dipole far-field sign); "auto" picks culled for big
    work, by the JAX package's rule: at least 1e10 point-triangle pairs and
    at least 32 chunks, the chunk shrunk towards 128 triangles to get them.
    ``devices`` (a mesh, parallel/mesh.get_mesh) shards the culled method's
    streams; ``point_chunk`` reaches it only when given.

    return_device=True returns tensors on the device (float32) instead of
    float64 numpy arrays.
    """
    vertices, faces = _mesh_arrays(mesh_or_vertices, faces)
    if method not in ("auto", "dense", "culled"):
        raise ValueError(f"unknown method {method!r}")
    n_pts, n_faces = len(points), len(faces)
    culled_tc = tri_chunk
    if method == "auto":
        # shrink the chunk so culling has >= 32 chunks of granularity
        while culled_tc > 128 and n_faces < 32 * culled_tc:
            culled_tc //= 2
        method = "culled" if n_faces >= 32 * culled_tc and n_pts * n_faces >= 1e10 else "dense"
    if method == "culled":
        from .sdf_culled import signed_distance_culled

        culled_kwargs = {} if point_chunk is None else {"point_chunk": point_chunk}
        with span("sdf.culled"):
            return signed_distance_culled(
                points, vertices, faces, return_normals=return_normals, tri_chunk=culled_tc,
                on_surface_eps=on_surface_eps, return_device=return_device, device=device,
                devices=devices, **culled_kwargs)
    with span("sdf.dense"):
        return _signed_distance_dense(points, vertices, faces, return_normals, point_chunk,
                                      tri_chunk, on_surface_eps, return_device, device)


def _signed_distance_dense(points, vertices, faces, return_normals: bool,
                           point_chunk: Optional[int], tri_chunk: int, on_surface_eps: float,
                           return_device: bool, device):
    """The all-pairs method of ``signed_distance``: the mesh's tables
    (``sdf.prepare_mesh``), the points and triangles to the device
    (``sdf.upload``), both streams over every (block, chunk) pair, the
    refinement, and the labels back (``sdf.gather``)."""
    n_pts, n_faces = len(points), len(faces)
    device = resolve_device(device)
    if n_pts == 0:
        if return_device:
            return (torch.zeros(0, device=device),
                    torch.zeros((0, 3), device=device) if return_normals else None)
        return np.zeros(0), (np.zeros((0, 3)) if return_normals else None)
    if n_faces == 0:
        # empty mesh: no surface -> far field everywhere (+inf, outside)
        if return_device:
            return (torch.full((n_pts,), torch.inf, device=device),
                    torch.zeros((n_pts, 3), device=device) if return_normals else None)
        return np.full(n_pts, np.inf), (np.zeros((n_pts, 3)) if return_normals else None)

    from .sdf_streams import dist_stream, stream_steps, wind_stream

    with span("sdf.prepare_mesh"):
        tables, F = _triangle_tables(vertices, faces, tri_chunk)
    with span("sdf.upload"):
        blocks, N, _ = _point_blocks(points, point_chunk, device)
    n_blocks = blocks.shape[0]
    # a dense keep matrix makes the segmented streams the all-pairs schedule
    sb, sc, _ = stream_steps(np.ones((n_blocks, tables["a"].shape[0]), bool), n_blocks)
    _, best = dist_stream(blocks, sb, sc, tables, tri_chunk)
    omega = wind_stream(blocks, sb, sc, tables, tri_chunk)
    best_idx = best[:n_blocks].reshape(-1)[:N].clamp(0, F - 1)
    omega = omega[:n_blocks].reshape(-1)[:N]

    # the triangles go up while the streams run
    with span("sdf.upload"):
        tri_flat = torch.from_numpy(
            np.asarray(vertices)[np.asarray(faces)].astype(np.float32).reshape(-1)
        ).to(device)
    flat = blocks.reshape(-1, 3)
    P_cols = (flat[:N, 0], flat[:N, 1], flat[:N, 2])
    sdf, grads = _refine_device(P_cols, tri_flat, best_idx, omega, on_surface_eps)

    if return_device:
        return sdf, (torch.stack(grads, dim=-1) if return_normals else None)
    with span("sdf.gather"):
        sdf = sdf.cpu().numpy().astype(np.float64)
        if not return_normals:
            return sdf, None
        return sdf, torch.stack(grads, dim=-1).cpu().numpy().astype(np.float64)


def winding_number(
    points,
    mesh_or_vertices,
    faces: Optional[np.ndarray] = None,
    *,
    point_chunk: int = 8192,
    tri_chunk: int = 1024,
    device=None,
) -> np.ndarray:
    """Generalized winding number of each point w.r.t. the mesh (~1 inside),
    through the matmul-form sweep (plain torch ops, as the JAX package
    leaves this function to XLA)."""
    vertices, faces = _mesh_arrays(mesh_or_vertices, faces)
    device = resolve_device(device)
    tables, _ = _triangle_tables(vertices, faces, tri_chunk)
    tables = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    blocks, N, _ = _point_blocks(np.asarray(points, np.float64), point_chunk, device)
    w = torch.cat([_sdf_point_block(blk, tables, tri_chunk)[2] for blk in blocks])
    return w[:N].cpu().numpy() / (4.0 * math.pi)
