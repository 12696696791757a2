"""Culled exact signed distance — counterpart of
sdf_representation_tpu/ops/sdf_culled.py (Morton culling, dipole far field,
streamed face slabs).

The all-pairs sweep of ``ops/sdf_exact.py`` costs O(N F). This module keeps
the distances exact and makes the work superlinear:

  * **Spatial sort**: faces are Morton-ordered by centroid, so each
    ``tri_chunk``-triangle chunk is compact; query points are Morton-ordered
    into ``point_chunk`` blocks.
  * **Distance culling** (exact): every point's distance d_pc to every
    chunk's bounding sphere gives the upper bound u_p = min_c (d_pc + r_c);
    chunk c survives for a block iff one of its points has d_pc - r_c <=
    u_p (+ slack). The winning triangle can never be culled.
  * **Fast winding number** (Jacobson et al. 2018): a chunk with d_pc >
    beta r_c + (beta + 1) delta_c for every point of a block contributes its
    dipole m . (cbar - P) / |cbar - P|^3; the others go through the exact
    winding stream. Only the sign's far field is approximate.

The culled (block, chunk) pairs become block-major step lists for the
distance and winding streams of ``ops/sdf_streams.py`` (kernels 4 and 5 on a
card), or, over a mesh of devices, for their sharded streams (kernels 6 and
7). The prepasses the JAX package leaves to XLA (cull, coarse bounds,
dipole) are torch ops here, batched over many blocks at once. Their dot
products with the points are formed elementwise (``sdf_streams._dots``),
never by a matrix product: the cull compares distances against a slack of
1e-3 of the scene's scale, which a TF32 product (set by
``torch.set_float32_matmul_precision("medium")``, as the trainer does around
its steps) would eat. Chunks are not padded to groups of ``_DIP_GROUP`` as
in the JAX package: a padding chunk is never kept and has zero moment.

``LAST_STAGE_SECONDS`` holds the host seconds of the last resident call's
stages (host_prep — the face sort and tables, and the points' Morton sort,
which runs on the device —, coarse_bound, cull, streams, dipole, refine),
each the span ``sdf.culled.<stage>`` (``utils/profiling.span``). No stage
waits for the card: a stage's seconds are the host's, and the card's work
lands in whichever later stage first reads a result (the cull's keep
masks, the labels' copy back). The card's own time per stage is read from
a trace, where the spans and the kernels share one clock. Inside the stages
the spans ``sdf.prepare_mesh`` (work that depends on the mesh alone),
``sdf.upload`` and ``sdf.gather`` (the labels back to the host) name the
same work as in the dense method. ``LAST_COUNTS`` holds the call's sizes
(blocks, chunks, surviving pairs sum_kd / sum_kw, shards), and
``CULL_PAIRS`` the process's running totals of the (block, chunk) pairs
the distance cull considered and kept (``reset_cull_pairs`` zeroes them).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span
from . import sdf_streams as ss
from .sdf_exact import _mesh_arrays, _refine_device, _triangle_tables

__all__ = ["signed_distance_culled", "signed_distance_streamed", "signed_distance_files",
           "StreamedLabeler"]

_DIP_GROUP = 1024  # chunks per step of the cull and dipole passes
_CULL_SLACK = 1e-3  # absorbs f32 rounding in the sphere-bound comparisons
# Exact coarse-field node sweep costs O(grid^3 * F) pairs; past this budget
# (~1M faces at grid=32) switch to the O(grid^3 * C) sphere-node bound.
_COARSE_EXACT_MAX_PAIRS = 3.2e10
# Past this many faces signed_distance_culled delegates to the face-slab path.
_RESIDENT_MAX_FACES = 1 << 25
# (block, point, chunk) entries per batched prepass step: 256 MB per f32
# intermediate, a few of them live at once
_BATCH_ENTRIES = 1 << 26

LAST_STAGE_SECONDS: dict = {}
LAST_COUNTS: dict = {}
CULL_PAIRS = {"considered": 0, "kept": 0}


def reset_cull_pairs() -> None:
    for key in CULL_PAIRS:
        CULL_PAIRS[key] = 0


# ---------------------------------------------------------------------------
# Host-side spatial preprocessing (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _morton3(q):
    """Interleave 10-bit coords (N, 3) int64 -> 30-bit Morton codes (N,);
    numpy arrays or tensors."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _morton_order(points):
    """Argsort of points along a Morton curve over their own AABB. A tensor
    is sorted where it lies (the same float32 quantisation, integer codes
    and stable order as the numpy path, so the same permutation)."""
    if isinstance(points, torch.Tensor):
        lo = points.amin(dim=0)
        span = torch.clamp_min(points.amax(dim=0) - lo, 1e-12)
        q = torch.clamp((points - lo) / span * 1023.0, 0, 1023).long()
        return torch.argsort(_morton3(q), stable=True)
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-12)
    q = np.clip((points - lo) / span * 1023.0, 0, 1023).astype(np.int64)
    return np.argsort(_morton3(q), kind="stable")


def _chunk_geometry(vertices: np.ndarray, faces: np.ndarray, tri_chunk: int,
                    super_faces: int = 4_194_304):
    """Per-chunk bounding spheres + dipole moments (valid triangles only).

    Returns (centers (C,3), radii (C,), m (C,3) area-vector sums, cbar (C,3)
    area-weighted centroids) as float64. The sphere is centred at the dipole
    expansion point cbar. ``super_faces`` faces are processed per sweep,
    which bounds the host memory."""
    F = len(faces)
    C = max(1, -(-F // tri_chunk))
    centers = np.zeros((C, 3))
    radii = np.zeros(C)
    m = np.zeros((C, 3))
    cbar = np.zeros((C, 3))
    if F == 0:
        return centers, radii, m, cbar
    chunks_per_super = max(1, super_faces // tri_chunk)
    for c0 in range(0, C, chunks_per_super):
        c1 = min(C, c0 + chunks_per_super)
        f0, f1 = c0 * tri_chunk, min(F, c1 * tri_chunk)
        t = vertices[faces[f0:f1]].astype(np.float64)  # (n, 3, 3)
        nc = c1 - c0
        n = f1 - f0
        pad = nc * tri_chunk - n
        if pad:
            t = np.concatenate([t, np.repeat(t[-1:], pad, axis=0)])
        vm = np.ones((nc, tri_chunk), np.float64)
        if pad:
            vm.reshape(-1)[n:] = 0.0
        t4 = t.reshape(nc, tri_chunk, 3, 3)
        av = 0.5 * np.cross(
            t4[:, :, 1] - t4[:, :, 0], t4[:, :, 2] - t4[:, :, 0]
        ) * vm[..., None]  # (nc, tc, 3); pads contribute zero moment
        m[c0:c1] = av.sum(axis=1)
        w = np.linalg.norm(av, axis=2)
        wsum = np.maximum(w.sum(axis=1), 1e-300)
        cb = (t4.mean(axis=2) * w[..., None]).sum(axis=1) / wsum[:, None]
        cbar[c0:c1] = cb
        centers[c0:c1] = cb
        d2 = ((t4.reshape(nc, -1, 3) - cb[:, None]) ** 2).sum(axis=-1)
        d2 *= np.repeat(vm, 3, axis=1)  # pads never set the radius
        radii[c0:c1] = np.sqrt(d2.max(axis=1))
    return centers, radii, m, cbar


def _host_points(points) -> np.ndarray:
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    return np.ascontiguousarray(points, dtype=np.float32)


def _sorted_blocks(points: np.ndarray, M: int, device):
    """The (N, 3) f32 points on ``device`` in Morton order, in a power-of-two
    count of M-point blocks, padded by repeating the last point (tight: a
    zero point would widen its block's bounds). The sort runs on the device
    (16.8M points of a 256^3 grid take seconds through numpy). Returns
    (order (N,) int64, P_blocks (n_blocks, M, 3) f32), both on ``device``."""
    pts = torch.from_numpy(points).to(device)
    order = _morton_order(pts)
    n_blocks = -(-len(points) // M)
    n_blocks = 1 << max(0, (n_blocks - 1).bit_length())
    P = torch.empty((n_blocks * M, 3), dtype=torch.float32, device=device)
    P[:len(points)] = pts[order]
    P[len(points):] = pts[order[-1]]
    return order, P.reshape(n_blocks, M, 3)


# ---------------------------------------------------------------------------
# Device prepasses (torch ops, full f32: see the module docstring)
# ---------------------------------------------------------------------------

def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def _sphere_dist(P, P2, c, c2) -> torch.Tensor:
    """|P - c| as sqrt(max(|c|^2 - 2 P.c + |P|^2, 0)): (G, M, 3) points,
    (G, M, 1) |P|^2, (Cg, 3) centres, (Cg,) |c|^2 -> (G, M, Cg)."""
    return torch.sqrt(torch.clamp_min(c2 - 2.0 * ss._dots(P, c) + P2, 0.0))


def _sq_norm(P: torch.Tensor) -> torch.Tensor:
    return ((P[..., 0] * P[..., 0] + P[..., 1] * P[..., 1]) + P[..., 2] * P[..., 2])[..., None]


def _batches(n_blocks: int, entries_per_block: int):
    step = max(1, _BATCH_ENTRIES // max(1, entries_per_block))
    return [(b0, min(n_blocks, b0 + step)) for b0 in range(0, n_blocks, step)]


def _cull(P_blocks, UB_blocks, chunk_centers, chunk_radii, beta, cbar=None,
          slack=_CULL_SLACK, group=_DIP_GROUP):
    """Candidate chunk sets per point block.

    P_blocks (B, M, 3) f32 (a tensor decides the device; numpy runs on the
    CPU); UB_blocks (B, M) per-point upper bounds on the true distance (inf,
    or a coarse bound). Returns (kd (B, C) bool distance candidates, kw
    (B, C) bool near-field winding chunks) as numpy. Conservative: the
    winning chunk is always in kd; every chunk NOT in kw satisfies the beta
    dipole criterion for every point of the block. The dipole is expanded
    about cbar, offset by delta from the sphere centre, so the nearness test
    in sphere-centre distance is d <= beta r + (beta + 1) delta. Chunks are
    visited in groups of ``group``: a first pass takes u_p, a second the
    keeps (one pass when one group holds every chunk).
    """
    P_blocks = torch.as_tensor(P_blocks)
    dev = P_blocks.device
    UB_blocks = torch.as_tensor(UB_blocks, dtype=torch.float32, device=dev)
    chunk_centers = np.asarray(chunk_centers, np.float64)
    C = len(chunk_centers)
    delta = (np.linalg.norm(np.asarray(cbar) - chunk_centers, axis=1)
             if cbar is not None else np.zeros(C))
    wthr = np.asarray(beta * np.asarray(chunk_radii) + (beta + 1.0) * delta, np.float32)
    c = _f32(chunk_centers, dev)
    c2 = _f32(np.einsum("ij,ij->i", chunk_centers, chunk_centers), dev)
    r = _f32(chunk_radii, dev)
    wthr_s = _f32(wthr + np.float32(slack), dev)  # f32 + f32, as the JAX cull adds them
    slack_t = _f32(slack, dev)
    groups = [(g0, min(C, g0 + group)) for g0 in range(0, C, group)]
    B, M = P_blocks.shape[:2]
    kd = torch.zeros((B, C), dtype=torch.bool, device=dev)
    kw = torch.zeros((B, C), dtype=torch.bool, device=dev)
    for b0, b1 in _batches(B, M * (groups[0][1] - groups[0][0])):
        P = P_blocks[b0:b1]
        P2 = _sq_norm(P)
        u = UB_blocks[b0:b1]
        dists = []
        for g0, g1 in groups:
            d = _sphere_dist(P, P2, c[g0:g1], c2[g0:g1])
            u = torch.minimum(u, (d + r[g0:g1]).amin(dim=2))
            if len(groups) == 1:
                dists.append(d)
        thr = (u + slack_t)[..., None]
        for i, (g0, g1) in enumerate(groups):
            d = dists[i] if dists else _sphere_dist(P, P2, c[g0:g1], c2[g0:g1])
            kd[b0:b1, g0:g1] = (d - r[g0:g1] <= thr).any(dim=1)
            kw[b0:b1, g0:g1] = (d <= wthr_s[g0:g1]).any(dim=1)
    return kd.cpu().numpy(), kw.cpu().numpy()


def _dipole_all_blocks(P_blocks: torch.Tensor, far: torch.Tensor, cbar: np.ndarray,
                       m: np.ndarray, group: int = _DIP_GROUP) -> torch.Tensor:
    """Dipole far-field solid angle of every block: (B, M) f32, the sum over
    the chunks with far (B, C) set of (m . cbar - P . m) / |cbar - P|^3."""
    dev = P_blocks.device
    B, M = P_blocks.shape[:2]
    C = len(cbar)
    cb, mv = _f32(cbar, dev), _f32(m, dev)
    cbar2 = _f32(np.einsum("ij,ij->i", cbar, cbar), dev)
    mdotc = _f32(np.einsum("ij,ij->i", m, cbar), dev)
    far = far.to(device=dev, dtype=torch.float32)
    groups = [(g0, min(C, g0 + group)) for g0 in range(0, C, group)]
    out = torch.zeros((B, M), dtype=torch.float32, device=dev)
    for b0, b1 in _batches(B, M * (groups[0][1] - groups[0][0])):
        P = P_blocks[b0:b1]
        P2 = _sq_norm(P)
        for g0, g1 in groups:
            r2 = torch.clamp_min(cbar2[g0:g1] - 2.0 * ss._dots(P, cb[g0:g1]) + P2, 1e-20)
            inv_r3 = torch.rsqrt(r2) / r2
            contrib = (mdotc[g0:g1] - ss._dots(P, mv[g0:g1])) * inv_r3 * far[b0:b1, None, g0:g1]
            out[b0:b1] += contrib.sum(dim=2)
    return out


def _node_lattice(P: torch.Tensor, grid: int):
    """The grid^3 lattice over the points' AABB: (lo (3,) f32, span (3,)
    f32, nodes (grid^3, 3) f64), numpy."""
    lo = P.amin(dim=0).cpu().numpy()
    hi = P.amax(dim=0).cpu().numpy()
    span = np.maximum(hi - lo, 1e-9)
    axes = [np.linspace(lo[k], hi[k], grid, dtype=np.float64) for k in range(3)]
    nodes = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return lo, span, nodes


def _bound_from_nodes(P: torch.Tensor, lo, span, d_nodes: torch.Tensor, grid: int,
                      eps: float) -> torch.Tensor:
    """d(p) <= d(nearest node) + |p - nearest node|, plus eps for rounding,
    on P's device with the JAX package's host arithmetic: f32 lattice
    indices, the residual in f64 rounded to f32."""
    dev = P.device
    lo_t, span_t = torch.from_numpy(lo).to(dev), torch.from_numpy(span).to(dev)
    cell = span_t / (grid - 1)
    nidx = torch.clamp(torch.round((P - lo_t) / cell), 0, grid - 1).long()
    diff = P.double() - (lo_t.double() + nidx.double() * cell.double())
    resid = torch.sqrt((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
                       + diff[:, 2] * diff[:, 2]).float()
    d = d_nodes.to(dev).reshape(-1)[(nidx[:, 0] * grid + nidx[:, 1]) * grid + nidx[:, 2]]
    return d + resid + _f32(eps, dev)


def _coarse_upper_bound(P_pad, tables, tri_chunk: int, grid: int = 32,
                        eps: float = 1e-4) -> torch.Tensor:
    """Tight per-point distance upper bound from an EXACT coarse field.

    Labels a grid^3 lattice over the query AABB with exact unsigned
    distances — the distance stream over every (node block, chunk) pair,
    which computes the same min d^2 as the JAX package's node sweep up to
    rounding that ``eps`` absorbs — then bounds every query by the triangle
    inequality d(p) <= d(nearest node) + |p - nearest node|. Conservative,
    so distances stay exact. P_pad: (N, 3) f32 (a tensor decides the
    device); returns (N,) f32 there."""
    P = torch.as_tensor(P_pad)
    lo, span, nodes = _node_lattice(P, grid)
    NB = 2048
    n_nb = -(-len(nodes) // NB)
    nodes_pad = np.zeros((n_nb * NB, 3), np.float32)
    nodes_pad[:len(nodes)] = nodes
    sb, sc, _ = ss.stream_steps(np.ones((n_nb, tables["a"].shape[0]), bool), n_nb)
    d2, _ = ss.dist_stream(torch.from_numpy(nodes_pad.reshape(n_nb, NB, 3)).to(P.device),
                           sb, sc, tables, tri_chunk)
    return _bound_from_nodes(P, lo, span, torch.sqrt(d2[:n_nb].reshape(-1)[:len(nodes)]), grid,
                             eps)


def _coarse_upper_bound_spheres(P_pad, centers: np.ndarray, radii: np.ndarray,
                                grid: int = 32, eps: float = 1e-4) -> torch.Tensor:
    """Per-point distance upper bound from CHUNK SPHERES at lattice nodes:
    each node is bounded by min_c(|node - c| + r_c), O(grid^3 C) instead of
    O(grid^3 F). Still a true upper bound (every triangle of a chunk lies in
    its sphere); looser than the exact field by the winning chunk's radius."""
    P = torch.as_tensor(P_pad)
    dev = P.device
    lo, span, nodes = _node_lattice(P, grid)
    c = _f32(centers, dev)
    c2 = _f32(np.einsum("ij,ij->i", centers, centers), dev)
    r = _f32(radii, dev)
    nodes_t = _f32(nodes, dev)
    d_nodes = torch.empty(len(nodes), dtype=torch.float32, device=dev)
    step = max(1, _BATCH_ENTRIES // max(1, len(centers)))
    for n0 in range(0, len(nodes), step):
        slab = nodes_t[n0:n0 + step]
        d_nodes[n0:n0 + step] = (_sphere_dist(slab, _sq_norm(slab), c, c2) + r).amin(dim=1)
    return _bound_from_nodes(P, lo, span, d_nodes, grid, eps)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _unsort(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows in Morton order back to the caller's order (out[order] = values)."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def _finish(sdf_s, grads_s, order: torch.Tensor, return_normals: bool, return_device: bool):
    with span("sdf.gather"):
        sdf = _unsort(sdf_s, order)
        grads = _unsort(torch.stack(grads_s, dim=-1), order) if return_normals else None
        if return_device:
            return sdf, grads
        return (sdf.cpu().numpy().astype(np.float64),
                None if grads is None else grads.cpu().numpy().astype(np.float64))


def signed_distance_culled(
    points,
    mesh_or_vertices,
    faces: Optional[np.ndarray] = None,
    *,
    return_normals: bool = True,
    point_chunk: int = 2048,
    tri_chunk: int = 1024,
    beta: float = 2.0,
    on_surface_eps: float = 1e-6,
    return_device: bool = False,
    coarse_bound: Optional[bool] = None,
    device=None,
    devices: Optional[Sequence] = None,
    dist_tri_chunk: Optional[int] = None,
):
    """Exact-distance, fast-winding signed distance for large meshes.

    Same contract as ops.sdf_exact.signed_distance: distances and the
    winner-triangle refinement are EXACT (conservative sphere culling); only
    the sign's far field uses the dipole approximation, controlled by
    ``beta`` (2.0 keeps the winding error orders below the 2 pi sign
    margin).

    device: where the prepasses, the streams and the refinement run (None:
    the card, raising without one; "cpu": the plain versions).
    devices: a mesh (``parallel/mesh.get_mesh``) to shard the two streams
    over, in contiguous point-block ranges, with the tables copied to every
    entry; taken when it has more than one entry and divides the block
    count, otherwise the streams run on ``device``.
    coarse_bound: tighten the cull with a per-point bound from a 32^3
    lattice (None: when N F >= 1e12).
    dist_tri_chunk: cull and run the DISTANCE stream at a finer chunk size
    than the winding partition (smaller spheres cull more pairs); the
    winding and the dipole stay at ``tri_chunk``. None: one size.
    """
    vertices, faces = _mesh_arrays(mesh_or_vertices, faces)
    device = resolve_device(device)
    points = _host_points(points)
    N = len(points)
    if N == 0:
        if return_device:
            return torch.zeros(0, device=device), torch.zeros((0, 3), device=device)
        return np.zeros(0), np.zeros((0, 3))
    if len(faces) == 0:
        # empty mesh: no surface, far field everywhere (+inf, outside)
        if return_device:
            return (torch.full((N,), torch.inf, device=device),
                    torch.zeros((N, 3), device=device) if return_normals else None)
        return np.full(N, np.inf), (np.zeros((N, 3)) if return_normals else None)

    if len(faces) > _RESIDENT_MAX_FACES:
        # beyond residency: stream face slabs (distances stay exact)
        d, g = signed_distance_streamed(
            points, vertices, faces, slab_faces=_RESIDENT_MAX_FACES,
            return_normals=return_normals, point_chunk=point_chunk, tri_chunk=tri_chunk,
            beta=beta, on_surface_eps=on_surface_eps, device=device)
        if return_device:
            return (torch.from_numpy(d).float().to(device),
                    torch.from_numpy(g).float().to(device) if return_normals else None)
        return d, g

    LAST_STAGE_SECONDS.clear()
    LAST_COUNTS.clear()

    def stage(name: str) -> span:
        return span(f"sdf.culled.{name}", LAST_STAGE_SECONDS, name)

    with stage("host_prep"):
        # Morton-sort faces (chunk compactness) and points (block coherence)
        with span("sdf.prepare_mesh"):
            vertices = np.asarray(vertices, dtype=np.float64)
            faces = np.asarray(faces, dtype=np.int64)
            faces_sorted = faces[_morton_order(vertices[faces].mean(axis=1))]
            tables, F = _triangle_tables(vertices, faces_sorted, tri_chunk)
            chunk_c, chunk_r, m, cbar = _chunk_geometry(vertices, faces_sorted, tri_chunk)
        C = len(chunk_c)
        M = point_chunk
        with span("sdf.upload"):
            order, P_blocks = _sorted_blocks(points, M, device)
        n_blocks = P_blocks.shape[0]

    with stage("coarse_bound"):
        if coarse_bound is None:
            coarse_bound = float(N) * float(F) >= 1e12
        # f32 rounding is relative to the coordinates' magnitude: the slacks
        # scale with the scene, so the winning chunk is never culled (the
        # padded blocks repeat a point: their largest |coordinate| is the points')
        scale = float(max(np.abs(vertices).max(initial=0.0), P_blocks.abs().max().item(), 1.0))
        if coarse_bound:
            P_pad = P_blocks.reshape(-1, 3)
            # the exact node sweep costs O(grid^3 F); past the budget the sphere
            # bound is within a chunk radius of it at O(grid^3 C)
            if 32 ** 3 * float(F) <= _COARSE_EXACT_MAX_PAIRS:
                ub = _coarse_upper_bound(P_pad, tables, tri_chunk, eps=1e-4 * scale)
            else:
                ub = _coarse_upper_bound_spheres(P_pad, chunk_c, chunk_r, eps=1e-4 * scale)
            UB_blocks = ub.reshape(n_blocks, M)
        else:
            UB_blocks = torch.full((n_blocks, M), torch.inf, device=device)

    with stage("cull"):
        kd, kw = _cull(P_blocks, UB_blocks, chunk_c, chunk_r, beta, cbar=cbar,
                       slack=_CULL_SLACK * scale)
        if dist_tri_chunk is None or dist_tri_chunk == tri_chunk:
            d_tc, kd_d, d_tables = tri_chunk, kd, tables
        else:
            d_tc = dist_tri_chunk
            with span("sdf.prepare_mesh"):
                d_tables, _ = _triangle_tables(vertices, faces_sorted, d_tc)
                cd, rd, _, cbard = _chunk_geometry(vertices, faces_sorted, d_tc)
            kd_d, _ = _cull(P_blocks, UB_blocks, cd, rd, beta, cbar=cbard,
                            slack=_CULL_SLACK * scale)
        db, dc, Sd = ss.stream_steps(kd_d, n_blocks)
        wb, wc, Sw = ss.stream_steps(kw, n_blocks)

    with stage("streams"):
        sharded = devices is not None and len(devices) > 1 and n_blocks % len(devices) == 0
        if sharded:
            _, best = ss.dist_stream_sharded(P_blocks, db, dc, d_tables, d_tc, devices)
            w = ss.wind_stream_sharded(P_blocks, wb, wc, tables, tri_chunk, devices)
            best, w = torch.from_numpy(best).to(device), torch.from_numpy(w).to(device)
        else:
            _, best = ss.dist_stream(P_blocks, db, dc, d_tables, d_tc)
            w = ss.wind_stream(P_blocks, wb, wc, tables, tri_chunk)
            best, w = best[:n_blocks], w[:n_blocks]

    with stage("dipole"):
        # the winding partition: exact over the beta-near chunks, dipole for ~kw
        omega_far = _dipole_all_blocks(P_blocks, torch.from_numpy(~kw), cbar, m)
        omega = (w + omega_far).reshape(-1)[:N]

    with stage("refine"):
        best_idx = best.reshape(-1)[:N].clamp(0, F - 1)
        with span("sdf.upload"):
            tri_flat = torch.from_numpy(
                vertices[faces_sorted].astype(np.float32).reshape(-1)).to(device)
        flat = P_blocks.reshape(-1, 3)
        P_cols = (flat[:N, 0], flat[:N, 1], flat[:N, 2])
        sdf_s, grads_s = _refine_device(P_cols, tri_flat, best_idx, omega, on_surface_eps)
        out = _finish(sdf_s, grads_s, order, return_normals, return_device)
    sum_kd = int(kd_d.sum())
    LAST_COUNTS.update(points=N, faces=F, blocks=n_blocks, point_chunk=M, tri_chunk=tri_chunk,
                       chunks=C, dist_tri_chunk=d_tc, dist_chunks=kd_d.shape[1],
                       sum_kd=sum_kd, sum_kw=int(kw.sum()), dist_steps=Sd,
                       wind_steps=Sw, coarse_bound=bool(coarse_bound),
                       shards=len(devices) if sharded else 1)
    CULL_PAIRS["considered"] += int(kd_d.size)
    CULL_PAIRS["kept"] += sum_kd
    return out


# ---------------------------------------------------------------------------
# Face slabs: meshes past residency, geometry split over many files
# ---------------------------------------------------------------------------

class StreamedLabeler:
    """Exact signed-distance accumulation across face slabs AND mesh shards.

    The running state — per point (min d^2, winner triangle's coordinates)
    and winding sum — combines across any partition of a watertight surface
    (or a union of watertight components) into pieces: face slabs of one
    mesh, or whole mesh files that never co-reside in host memory.
    Construct once with the query points, ``add()`` each vertex/face shard,
    then ``finish()`` refines on the stored winner triangles and signs by
    the accumulated winding. The state lives on ``device``.

    Exact for the reason ``signed_distance_culled`` is: each slab's cull
    bound is a true upper bound on the global minimum (the shard's sphere
    bound, tightened by the best distance of earlier slabs), so the winner
    is never culled; winding numbers add over any disjoint face partition.
    """

    def __init__(self, points, *, slab_faces: int = 1 << 24, point_chunk: int = 2048,
                 tri_chunk: int = 1024, beta: float = 2.0, on_surface_eps: float = 1e-6,
                 device=None):
        points = _host_points(points)
        self.device = resolve_device(device)
        self.N = len(points)
        self.slab_faces = slab_faces
        self.tri_chunk = tri_chunk
        self.beta = beta
        self.on_surface_eps = on_surface_eps
        if self.N == 0:
            return
        self.M = point_chunk
        self.order, self.P_blocks = _sorted_blocks(points, point_chunk, self.device)
        self.n_blocks = self.P_blocks.shape[0]
        self.point_scale = float(max(np.abs(points).max(initial=0.0), 1.0))
        n_pad = self.n_blocks * point_chunk
        self.run_d2 = torch.full((n_pad,), torch.inf, dtype=torch.float32, device=self.device)
        self.run_w = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        # winner triangle coordinates, Morton point order (N, 9): stored per
        # improvement, so a shard can be dropped after its add()
        self.run_tri = torch.zeros((self.N, 9), dtype=torch.float32, device=self.device)

    def add(self, vertices, faces) -> None:
        """Accumulate one shard: a (V, 3) / (F, 3) piece of the geometry."""
        if self.N == 0:
            return
        vertices = np.asarray(vertices, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        F = len(faces)
        if F == 0:
            return
        dev, tri_chunk, N = self.device, self.tri_chunk, self.N
        faces_sorted = faces[_morton_order(vertices[faces].mean(axis=1))]
        chunk_c, chunk_r, mom, cbar = _chunk_geometry(vertices, faces_sorted, tri_chunk)
        C = len(chunk_c)
        chunks_per_slab = max(1, self.slab_faces // tri_chunk)
        scale = float(max(np.abs(vertices).max(initial=0.0), self.point_scale))
        ub_shard = _coarse_upper_bound_spheres(self.P_blocks.reshape(-1, 3), chunk_c, chunk_r,
                                               eps=1e-4 * scale)
        eps = _f32(1e-4 * scale, dev)
        for c0 in range(0, C, chunks_per_slab):
            c1 = min(C, c0 + chunks_per_slab)
            f0, f1 = c0 * tri_chunk, min(F, c1 * tri_chunk)
            tables, _ = _triangle_tables(vertices, faces_sorted[f0:f1], tri_chunk)
            # the shard's bound tightened by the running best distance: a
            # true upper bound on the global minimum
            ub_now = torch.minimum(ub_shard, torch.sqrt(self.run_d2) + eps)
            kd, kw = _cull(self.P_blocks, ub_now.reshape(self.n_blocks, self.M), chunk_c[c0:c1],
                           chunk_r[c0:c1], self.beta, cbar=cbar[c0:c1],
                           slack=_CULL_SLACK * scale)
            db, dc, _ = ss.stream_steps(kd, self.n_blocks)
            wb, wc, _ = ss.stream_steps(kw, self.n_blocks)
            d2, best = ss.dist_stream(self.P_blocks, db, dc, tables, tri_chunk)
            w = ss.wind_stream(self.P_blocks, wb, wc, tables, tri_chunk)
            omega_far = _dipole_all_blocks(self.P_blocks, torch.from_numpy(~kw), cbar[c0:c1],
                                           mom[c0:c1])
            d2_s = d2[:self.n_blocks].reshape(-1)
            better = d2_s < self.run_d2
            self.run_d2 = torch.where(better, d2_s, self.run_d2)
            self.run_w += (w[:self.n_blocks] + omega_far).reshape(-1)
            # the improved winners' coordinates now: the shard is gone by finish()
            bn = better[:N]
            tri = torch.from_numpy(
                vertices[faces_sorted[f0:f1]].astype(np.float32).reshape(-1, 9)).to(dev)
            win = best[:self.n_blocks].reshape(-1)[:N][bn].long().clamp(0, f1 - f0 - 1)
            self.run_tri[bn] = tri[win]

    def finish(self, return_normals: bool = True):
        """Refine on the accumulated winner triangles; sign by winding.
        Returns float64 numpy (sdf (N,), normals (N, 3) or None)."""
        if self.N == 0:
            return np.zeros(0), np.zeros((0, 3))
        N = self.N
        if not torch.isfinite(self.run_d2[:N]).any():
            return np.full(N, np.inf), np.zeros((N, 3))
        flat = self.P_blocks.reshape(-1, 3)
        P_cols = (flat[:N, 0], flat[:N, 1], flat[:N, 2])
        sdf_s, grads_s = _refine_device(
            P_cols, self.run_tri.reshape(-1), torch.arange(N, device=self.device),
            self.run_w[:N], self.on_surface_eps)
        return _finish(sdf_s, grads_s, self.order, return_normals, False)


def signed_distance_streamed(points, mesh_or_vertices, faces: Optional[np.ndarray] = None, *,
                             slab_faces: int = 1 << 24, return_normals: bool = True,
                             point_chunk: int = 2048, tri_chunk: int = 1024, beta: float = 2.0,
                             on_surface_eps: float = 1e-6, device=None) -> Tuple:
    """signed_distance_culled for meshes whose tables exceed the device.

    Faces are Morton-sorted globally, then processed in ``slab_faces``-face
    resident slabs with the cull and streams of signed_distance_culled; the
    running (min d^2, winner) and winding sum combine across slabs, each
    slab's bound tightened by the best distance so far. Distances stay
    exact. Returns float64 numpy arrays."""
    vertices, faces = _mesh_arrays(mesh_or_vertices, faces)
    points = _host_points(points)
    if len(points) == 0:
        return np.zeros(0), np.zeros((0, 3))
    acc = StreamedLabeler(points, slab_faces=slab_faces, point_chunk=point_chunk,
                          tri_chunk=tri_chunk, beta=beta, on_surface_eps=on_surface_eps,
                          device=device)
    acc.add(vertices, faces)
    return acc.finish(return_normals=return_normals)


def signed_distance_files(points, mesh_paths, *, slab_faces: int = 1 << 24,
                          return_normals: bool = True, point_chunk: int = 2048,
                          tri_chunk: int = 1024, beta: float = 2.0, on_surface_eps: float = 1e-6,
                          device=None) -> Tuple:
    """Exact signed distance against a geometry split over mesh FILES that
    together form a watertight surface (or a union of watertight
    components). One file is in host memory at a time, streamed through the
    device in slabs. Distances are the minimum over ALL files and signs come
    from the summed winding number, so a file's open boundary cannot flip
    a sign. Returns float64 numpy arrays."""
    from ..geometry.mesh_io import load_mesh

    acc = StreamedLabeler(points, slab_faces=slab_faces, point_chunk=point_chunk,
                          tri_chunk=tri_chunk, beta=beta, on_surface_eps=on_surface_eps,
                          device=device)
    for path in mesh_paths:
        mesh = load_mesh(str(path))
        acc.add(mesh.vertices, mesh.faces)
        del mesh
    return acc.finish(return_normals=return_normals)
