"""Exact-SDF work streams — counterpart of sdf_representation_tpu/ops/pallas_streams.py.

Two streams over a schedule of (point block, triangle chunk) steps:

  ``dist_stream``  per point the minimum squared distance to the triangles of
                   its block's chunks and the face that gives it
                   (<- _dist_kernel, the pallas_call in _dist_slab_call)
  ``wind_stream``  per point the summed solid angle of those triangles
                   (<- _wind_kernel, the pallas_call in _wind_slab_call)

The schedule keeps the JAX interface ``(P_blocks, step_block, step_chunk,
tables, tri_chunk)``: ``ops/sdf_exact.py`` calls it with every (block, chunk)
pair; a culled caller passes fewer steps. Steps that name block ``B`` (the
sink) are padding. Results are (B + 1, M) with row B the sink; rows no step
visits read +inf / face 0 / angle 0.

The sharded streams ``dist_stream_sharded`` and ``wind_stream_sharded``
(<- the pallas_calls in dist_stream_pallas_sharded / wind_stream_pallas_sharded)
split the point blocks over a mesh (``parallel/mesh.py``: a tuple of
devices) in contiguous ranges, one per entry (``per_device_steps``), and
launch the same kernels once per shard on its device with a copy of the
packed table; the results are gathered to the host.

Each wrapper takes its kernel's plain PyTorch version (``*_plain``) when the
points lie on the CPU, and launches the CUDA kernel (``csrc/sdf_streams.cu``)
or raises when they lie on a card: there is no fallback. ``LAUNCHES`` counts
kernel launches, a sharded stream one per shard. All arithmetic is float32:
no TF32, no bf16.

Host-side pieces of a launch: the distance kernel reads its own table
(``pack_dist_kernel_table``: the Eberly solve's per-triangle terms computed
once, here), the schedule as per-block chunk ranges (``block_ranges``) and
the blocks in launch order, longest chunk list first (``launch_order``).
``atan2_poly`` is the JAX winding kernel's polynomial atan2, which
``wind_kernel`` evaluates. On a card the packing, the ranges and their
uploads run under the span ``sdf.streams.schedule`` (``utils/profiling.span``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..parallel.mesh import mesh_kind
from ..utils.profiling import span
from .sdf_exact import _eberly_st

# distance-table columns (15 used, padded to 16): the tile pass needs P.E0 and
# P.E1 (d = e0v0 - P.E0, e = e1v0 - P.E1) plus v0/E0/E1 for the closest point
_D_V0, _D_E0, _D_E1 = 0, 3, 6
_D_A, _D_B, _D_C, _D_E0V0, _D_E1V0, _D_VALID = 9, 10, 11, 12, 13, 14
_D_ROWS = 16

# winding-table columns (20 used, padded to 24)
_W_V0, _W_V1, _W_V2, _W_K = 0, 3, 6, 9
_W_N00, _W_N11, _W_N22, _W_N01, _W_N12, _W_N20, _W_D0, _W_VALID = 12, 13, 14, 15, 16, 17, 18, 19
_W_ROWS = 24

# kernel launches per wrapper; chip_smoke.py zeroes them around the main path
LAUNCHES = {"dist_stream": 0, "wind_stream": 0, "dist_stream_sharded": 0, "wind_stream_sharded": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def stream_tiling_ok(tri_chunk: int, m: int) -> bool:
    """True iff the streams can tile (tri_chunk, m) without dropping work.
    The CUDA kernels walk a chunk in ring stages of a fixed number of
    triangles with a ragged last stage and mask points past ``m``, so any
    positive tiling is covered (the TPU kernels need multiples of their
    128 x 1024 strips)."""
    return tri_chunk >= 1 and m >= 1


def _check_tiling(tri_chunk: int, m: int) -> None:
    if not stream_tiling_ok(tri_chunk, m):
        raise ValueError(f"the streams need tri_chunk >= 1 and point_chunk >= 1, "
                         f"got {tri_chunk} and {m}")


def pack_dist_table(tables: Dict[str, np.ndarray], tri_chunk: int) -> np.ndarray:
    """(C, T, 16) f32 from the ``_triangle_tables`` dict (host, once): one
    row of constants per triangle, so a chunk is one dense block."""
    C = tables["a"].shape[0]
    out = np.zeros((C, tri_chunk, _D_ROWS), np.float32)
    for base, key in ((_D_V0, "v0"), (_D_E0, "E0"), (_D_E1, "E1")):
        out[:, :, base:base + 3] = tables[key]
    for col, key in ((_D_A, "a"), (_D_B, "b"), (_D_C, "c"), (_D_E0V0, "e0v0"),
                     (_D_E1V0, "e1v0"), (_D_VALID, "valid")):
        out[:, :, col] = tables[key]
    return out


def pack_wind_table(tables: Dict[str, np.ndarray], tri_chunk: int) -> np.ndarray:
    """(C, T, 24) f32 winding constants (layout: see pack_dist_table)."""
    C = tables["d0"].shape[0]
    out = np.zeros((C, tri_chunk, _W_ROWS), np.float32)
    for base, key in ((_W_V0, "v0"), (_W_V1, "v1"), (_W_V2, "v2"), (_W_K, "K")):
        out[:, :, base:base + 3] = tables[key]
    for col, key in ((_W_N00, "n00"), (_W_N11, "n11"), (_W_N22, "n22"), (_W_N01, "n01"),
                     (_W_N12, "n12"), (_W_N20, "n20"), (_W_D0, "d0"), (_W_VALID, "valid")):
        out[:, :, col] = tables[key]
    return out


# distance-KERNEL table columns (20): the terms of the Eberly solve that
# depend on the triangle only come computed, and d, e are formed from
# w = P - v0 (csrc/sdf_streams.cu pair_d2)
_K_E0, _K_A, _K_E1, _K_C, _K_V0, _K_B = 0, 3, 4, 7, 8, 11
_K_DET, _K_INV_DET, _K_INV_A, _K_INV_C, _K_INV_DEN, _K_CB, _K_AB = 12, 13, 14, 15, 16, 17, 18
_K_ROWS = 20
_PAD_V0X = 1e20  # a padding row's v0.x: (x - 1e20)^2 overflows to +inf


def pack_dist_kernel_table(tables: Dict[str, np.ndarray], tri_chunk: int) -> np.ndarray:
    """(C, T, 20) f32 rows of dist_kernel: E0, a, E1, c, v0, b, then the
    per-triangle terms of ``_eberly_st`` in its own expressions (det = max(ac
    - b^2, eps), 1/max(a, eps), 1/max(c, eps), max(a - 2b + c, eps)) as det,
    1/det, 1/a, 1/c and 1/(a - 2b + c), and c - b, a - b. Padding rows
    (valid == 0) have no edges and v0 = (1e20, 0, 0), so their d^2 is +inf."""
    f32, eps = np.float32, np.float32(1e-30)
    pad = tables["valid"] <= 0
    E0 = np.where(pad[..., None], f32(0), tables["E0"]).astype(f32)
    E1 = np.where(pad[..., None], f32(0), tables["E1"]).astype(f32)
    v0 = np.where(pad[..., None], f32(0), tables["v0"]).astype(f32)
    v0[..., 0][pad] = _PAD_V0X
    a, b, c = (np.where(pad, f32(0), tables[k]).astype(f32) for k in "abc")
    det = np.maximum(a * c - b * b, eps)
    den = np.maximum(a - f32(2) * b + c, eps)
    C = a.shape[0]
    out = np.zeros((C, tri_chunk, _K_ROWS), f32)
    out[..., _K_E0:_K_E0 + 3], out[..., _K_A] = E0, a
    out[..., _K_E1:_K_E1 + 3], out[..., _K_C] = E1, c
    out[..., _K_V0:_K_V0 + 3], out[..., _K_B] = v0, b
    out[..., _K_DET], out[..., _K_INV_DET] = det, f32(1) / det
    out[..., _K_INV_A] = f32(1) / np.maximum(a, eps)
    out[..., _K_INV_C] = f32(1) / np.maximum(c, eps)
    out[..., _K_INV_DEN], out[..., _K_CB], out[..., _K_AB] = f32(1) / den, c - b, a - b
    return out


def stream_steps(keep: np.ndarray, sink: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flatten a (B, C) keep matrix into block-major (step_block,
    step_chunk) int32 arrays, padded to a power of two with sink steps
    (sdf_culled._stream_steps)."""
    blocks, chunks = np.nonzero(keep)
    S = len(blocks)
    S_pad = 1 << max(0, (max(S, 1) - 1).bit_length())
    sb = np.full(S_pad, sink, np.int32)
    sc = np.zeros(S_pad, np.int32)
    sb[:S] = blocks
    sc[:S] = chunks
    return sb, sc, S


def block_ranges(step_block, step_chunk, n_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """The step list as per-block ranges: (offs (B + 1,), chunks (S,)) int32
    with block b's chunks at chunks[offs[b]:offs[b + 1]], in step order (the
    order decides ties between chunks). Sink steps are dropped."""
    sb = np.asarray(step_block, np.int64)
    sc = np.asarray(step_chunk, np.int32)
    live = (sb >= 0) & (sb < n_blocks)
    sb, sc = sb[live], sc[live]
    order = np.argsort(sb, kind="stable")
    offs = np.zeros(n_blocks + 1, np.int32)
    offs[1:] = np.cumsum(np.bincount(sb, minlength=n_blocks))
    return offs, np.ascontiguousarray(sc[order])


def launch_order(offs: np.ndarray) -> np.ndarray:
    """The point blocks in launch order (int32): longest chunk list first,
    ties in block order. The kernels' CTAs take blocks in this order, so the
    longest walks start first and a culled schedule's short ones fill the
    tail."""
    return np.argsort(-np.diff(np.asarray(offs, np.int64)), kind="stable").astype(np.int32)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The JAX winding kernel's full-quadrant atan2 (pallas_streams._atan2)
    in torch f32, operation for operation: atan(q) = q P(q^2) for q =
    min(|x|, |y|) / max(|x|, |y|, 1e-30), then the quadrant fix-ups. Max
    error ~2e-6 (atan(q) ~ 0.99997726 q for small q). ``wind_kernel``
    evaluates this polynomial with a reciprocal and contracted steps, and
    takes the sign of y as atan2 does (this copy, as the JAX one, gives
    y = -0 the sign of +0)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    ax, ay = x.abs(), y.abs()
    q = torch.minimum(ax, ay) / torch.maximum(torch.maximum(ax, ay), f32(1e-30))
    s = q * q
    p = torch.full_like(s, -0.0117212)
    for coef in (0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726):
        p = p * s + f32(coef)
    r = q * p
    r = torch.where(ay > ax, f32(np.pi / 2) - r, r)
    r = torch.where(x < 0, f32(np.pi) - r, r)
    return torch.where(y < 0, -r, r)


def _check_points(P_blocks: torch.Tensor) -> Tuple[int, int]:
    if not isinstance(P_blocks, torch.Tensor) or P_blocks.dim() != 3 or P_blocks.shape[2] != 3:
        raise ValueError("P_blocks must be a (B, M, 3) tensor")
    if P_blocks.dtype != torch.float32:
        raise ValueError(f"P_blocks must be float32, got {P_blocks.dtype}")
    return P_blocks.shape[0], P_blocks.shape[1]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; on a card only compared against)
# ---------------------------------------------------------------------------

def _dots(P: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) points . (T, 3) vectors -> (..., M, T), as three float32
    products summed left to right (no matmul: nothing may round the
    operands, whatever the global matmul precision)."""
    return (P[..., 0:1] * V[:, 0] + P[..., 1:2] * V[:, 1]) + P[..., 2:3] * V[:, 2]


def _dist_tile(P: torch.Tensor, tt: torch.Tensor):
    """One (M points x T triangles) distance tile: (M, T) squared distances
    of the Eberly closest points, +inf for padding triangles."""
    col = lambda c: tt[:, c]
    d = col(_D_E0V0) - _dots(P, tt[:, _D_E0:_D_E0 + 3])
    e = col(_D_E1V0) - _dots(P, tt[:, _D_E1:_D_E1 + 3])
    s, t = _eberly_st(col(_D_A), col(_D_B), col(_D_C), d, e)
    d2 = None
    for k in range(3):
        dk = P[:, k:k + 1] - ((col(_D_V0 + k) + s * col(_D_E0 + k)) + t * col(_D_E1 + k))
        d2 = dk * dk if d2 is None else d2 + dk * dk
    return torch.where(col(_D_VALID) > 0, d2, torch.inf)


def _wind_tile(P: torch.Tensor, tt: torch.Tensor, dots: Callable = _dots) -> torch.Tensor:
    """One winding tile: (M,) summed solid angles of the T triangles, in the
    table form n00 - 2 P.v0 + |P|^2 of the JAX kernel. ``dots`` computes the
    four P . [v0 v1 v2 K] products (a check may pass a rounding one)."""
    col = lambda c: tt[:, c]
    p2 = ((P[:, 0] * P[:, 0] + P[:, 1] * P[:, 1]) + P[:, 2] * P[:, 2])[:, None]
    pv0 = dots(P, tt[:, _W_V0:_W_V0 + 3])
    pv1 = dots(P, tt[:, _W_V1:_W_V1 + 3])
    pv2 = dots(P, tt[:, _W_V2:_W_V2 + 3])
    pk = dots(P, tt[:, _W_K:_W_K + 3])
    la = torch.sqrt(torch.clamp_min(col(_W_N00) - 2.0 * pv0 + p2, 1e-30))
    lb = torch.sqrt(torch.clamp_min(col(_W_N11) - 2.0 * pv1 + p2, 1e-30))
    lc = torch.sqrt(torch.clamp_min(col(_W_N22) - 2.0 * pv2 + p2, 1e-30))
    ab = col(_W_N01) - pv0 - pv1 + p2
    bc = col(_W_N12) - pv1 - pv2 + p2
    ca = col(_W_N20) - pv2 - pv0 + p2
    numer = col(_W_D0) - pk
    denom = la * lb * lc + ab * lc + bc * la + ca * lb
    omega = 2.0 * torch.atan2(numer, denom) * col(_W_VALID)
    return omega.sum(dim=1)


def dist_stream_plain(P_blocks: torch.Tensor, step_block, step_chunk, tables, tri_chunk: int):
    """``dist_stream`` as torch ops walking the same steps, one (M, T) tile
    per step; the first minimal face index wins ties."""
    B, M = _check_points(P_blocks)
    _check_tiling(tri_chunk, M)
    dev = P_blocks.device
    tab = torch.from_numpy(pack_dist_table(tables, tri_chunk)).to(dev)
    out_d2 = torch.full((B + 1, M), torch.inf, dtype=torch.float32, device=dev)
    out_best = torch.zeros((B + 1, M), dtype=torch.int32, device=dev)
    tri = torch.arange(tri_chunk, dtype=torch.int32, device=dev)
    offs, chunks = block_ranges(step_block, step_chunk, B)
    for b in range(B):
        for c in chunks[offs[b]:offs[b + 1]].tolist():
            d2 = _dist_tile(P_blocks[b], tab[c])
            loc_min = d2.min(dim=1).values
            loc_arg = torch.where(d2 <= loc_min[:, None], tri, tri_chunk).min(dim=1).values
            better = loc_min < out_d2[b]
            out_d2[b] = torch.where(better, loc_min, out_d2[b])
            out_best[b] = torch.where(better, c * tri_chunk + loc_arg, out_best[b])
    return out_d2, out_best


def wind_stream_plain(P_blocks: torch.Tensor, step_block, step_chunk, tables, tri_chunk: int,
                      dots: Callable = _dots) -> torch.Tensor:
    """``wind_stream`` as torch ops walking the same steps."""
    B, M = _check_points(P_blocks)
    _check_tiling(tri_chunk, M)
    dev = P_blocks.device
    tab = torch.from_numpy(pack_wind_table(tables, tri_chunk)).to(dev)
    out_w = torch.zeros((B + 1, M), dtype=torch.float32, device=dev)
    offs, chunks = block_ranges(step_block, step_chunk, B)
    for b in range(B):
        for c in chunks[offs[b]:offs[b + 1]].tolist():
            out_w[b] += _wind_tile(P_blocks[b], tab[c], dots)
    return out_w


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = kernels.load("sdf_streams")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sdf_dist_stream.argtypes = [P, P, P, P, P, I, I, I, P, P, P]
    lib.sdf_wind_stream.argtypes = [P, P, P, P, P, I, I, I, P, P]
    lib.sdf_dist_stream.restype = lib.sdf_wind_stream.restype = I
    lib.sdf_streams_layout.argtypes = [P]
    lib.sdf_streams_layout.restype = None
    lib.sdf_streams_error_string.argtypes = [I]
    lib.sdf_streams_error_string.restype = ctypes.c_char_p
    _check_layout(_read_layout(lib))
    return lib


_LAYOUT_KEYS = ("points_per_thread", "threads", "dist_stage_triangles", "wind_stage_triangles",
                "stages", "dist_rows", "wind_rows", "dist_ring_bytes", "wind_ring_bytes")


def _read_layout(lib: ctypes.CDLL) -> Dict[str, int]:
    out = (ctypes.c_int * len(_LAYOUT_KEYS))()
    lib.sdf_streams_layout(ctypes.addressof(out))
    return dict(zip(_LAYOUT_KEYS, out))


def _check_layout(layout: Dict[str, int]) -> None:
    """The built kernels must read the tables as pack_dist_kernel_table and
    pack_wind_table write them."""
    if (layout["dist_rows"], layout["wind_rows"]) != (_K_ROWS, _W_ROWS):
        raise RuntimeError(f"csrc/sdf_streams.cu reads {layout['dist_rows']} / "
                           f"{layout['wind_rows']} floats a triangle, ops/sdf_streams.py packs "
                           f"{_K_ROWS} / {_W_ROWS}")


def kernel_layout() -> Dict[str, int]:
    """The built kernels' CTA shape and tables: points per thread, threads
    per CTA, triangles per ring stage of each kernel, ring stages, floats
    per triangle of each kernel's table, and each kernel's ring in bytes."""
    return _read_layout(_lib())


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().sdf_streams_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _cuda_schedule(P_blocks, step_block, step_chunk, table: np.ndarray):
    """Validate a launch; returns (table, offs, chunks, order) on the
    points' card."""
    B, _ = _check_points(P_blocks)
    if not P_blocks.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    with span("sdf.streams.schedule"):
        offs, chunks = block_ranges(step_block, step_chunk, B)
        if len(chunks) and (chunks.min() < 0 or chunks.max() >= table.shape[0]):
            raise ValueError("a step names a triangle chunk outside the table")
        dev = P_blocks.device
        return tuple(torch.from_numpy(a).to(dev) for a in (table, offs, chunks, launch_order(offs)))


def _dist_launch(P_blocks: torch.Tensor, step_block, step_chunk, table: np.ndarray,
                 tri_chunk: int):
    """One dist_kernel launch over (B, M, 3) points on their card with the
    packed distance-kernel table; returns (d2, best), both (B + 1, M)."""
    B, M = P_blocks.shape[:2]
    tab, offs, chunks, order = _cuda_schedule(P_blocks, step_block, step_chunk, table)
    dev = P_blocks.device
    out_d2 = torch.empty((B + 1, M), dtype=torch.float32, device=dev)
    out_best = torch.empty((B + 1, M), dtype=torch.int32, device=dev)
    out_d2[B] = torch.inf
    out_best[B] = 0
    if B:
        with torch.cuda.device(dev):
            rc = _lib().sdf_dist_stream(
                P_blocks.data_ptr(), tab.data_ptr(), offs.data_ptr(), chunks.data_ptr(),
                order.data_ptr(), B, M, tri_chunk, out_d2.data_ptr(), out_best.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(rc, "dist_stream")
    return out_d2, out_best


def _wind_launch(P_blocks: torch.Tensor, step_block, step_chunk, table: np.ndarray,
                 tri_chunk: int) -> torch.Tensor:
    """One wind_kernel launch (see _dist_launch); returns (B + 1, M) angles."""
    B, M = P_blocks.shape[:2]
    tab, offs, chunks, order = _cuda_schedule(P_blocks, step_block, step_chunk, table)
    dev = P_blocks.device
    out_w = torch.empty((B + 1, M), dtype=torch.float32, device=dev)
    out_w[B] = 0.0
    if B:
        with torch.cuda.device(dev):
            rc = _lib().sdf_wind_stream(
                P_blocks.data_ptr(), tab.data_ptr(), offs.data_ptr(), chunks.data_ptr(),
                order.data_ptr(), B, M, tri_chunk, out_w.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(rc, "wind_stream")
    return out_w


def dist_stream(P_blocks: torch.Tensor, step_block, step_chunk, tables, tri_chunk: int):
    """Distance stream over (B, M, 3) f32 points. Returns (d2 (B + 1, M) f32,
    best (B + 1, M) i32): per point the minimum squared distance to the
    triangles of its block's chunks and the winning face (chunk * tri_chunk
    + index in the chunk; the first minimal index wins)."""
    B, M = _check_points(P_blocks)
    if P_blocks.device.type == "cpu":
        return dist_stream_plain(P_blocks, step_block, step_chunk, tables, tri_chunk)
    _check_tiling(tri_chunk, M)
    with span("sdf.streams.schedule"):
        table = pack_dist_kernel_table(tables, tri_chunk)
    out = _dist_launch(P_blocks, step_block, step_chunk, table, tri_chunk)
    if B:
        LAUNCHES["dist_stream"] += 1
    return out


def wind_stream(P_blocks: torch.Tensor, step_block, step_chunk, tables,
                tri_chunk: int) -> torch.Tensor:
    """Winding stream over (B, M, 3) f32 points. Returns (B + 1, M) f32: per
    point the summed solid angle of the triangles of its block's chunks
    (4 pi times the winding number when every chunk is visited)."""
    B, M = _check_points(P_blocks)
    if P_blocks.device.type == "cpu":
        return wind_stream_plain(P_blocks, step_block, step_chunk, tables, tri_chunk)
    _check_tiling(tri_chunk, M)
    with span("sdf.streams.schedule"):
        table = pack_wind_table(tables, tri_chunk)
    out = _wind_launch(P_blocks, step_block, step_chunk, table, tri_chunk)
    if B:
        LAUNCHES["wind_stream"] += 1
    return out


# ---------------------------------------------------------------------------
# sharded over a mesh of devices (kernels 6 and 7)
# ---------------------------------------------------------------------------

def per_device_steps(step_block, step_chunk, B: int, n_dev: int):
    """Split block-major steps into per-device local schedules
    (pallas_streams._per_device_steps). Device d owns the contiguous blocks
    [d B/n_dev, (d + 1) B/n_dev) (Morton-coherent blocks keep similar chunk
    counts, so contiguous ranges balance). Returns (sb (D, S_max + 1), sc
    (D, S_max + 1)) int32 with LOCAL block ids, each row led by the -1
    sentinel and padded with local-sink (B / n_dev) steps to a power-of-two
    common length."""
    step_block, step_chunk = np.asarray(step_block), np.asarray(step_chunk)
    B_local = B // n_dev
    sbs, scs = [], []
    s_max = 1
    for d in range(n_dev):
        lo, hi = d * B_local, (d + 1) * B_local
        sel = (step_block >= lo) & (step_block < hi)
        sbs.append(step_block[sel] - lo)
        scs.append(step_chunk[sel])
        s_max = max(s_max, len(sbs[-1]))
    s_max = 1 << max(0, (s_max - 1).bit_length())
    sb = np.full((n_dev, s_max + 1), B_local, np.int32)
    sc = np.zeros((n_dev, s_max + 1), np.int32)
    sb[:, 0] = -1
    for d in range(n_dev):
        n = len(sbs[d])
        sb[d, 1:n + 1] = sbs[d]
        sc[d, 1:n + 1] = scs[d]
    return sb, sc


def _shards(P_blocks, step_block, step_chunk, tri_chunk: int, devices: Sequence) -> Iterator:
    """Per mesh entry: (its points, on its device; local step_block; local
    step_chunk). The points may be a numpy array or a tensor anywhere."""
    P_blocks = torch.as_tensor(P_blocks)
    B, M = _check_points(P_blocks)
    _check_tiling(tri_chunk, M)
    n_dev = len(devices)
    if n_dev < 1 or B % n_dev:
        raise ValueError(f"{B} point blocks do not split evenly over {n_dev} devices")
    B_local = B // n_dev
    sb, sc = per_device_steps(step_block, step_chunk, B, n_dev)
    for d, dev in enumerate(devices):
        yield P_blocks[d * B_local:(d + 1) * B_local].to(dev), sb[d, 1:], sc[d, 1:]


def _gather(parts) -> np.ndarray:
    """Shard outputs (B_local + 1, M) each -> host (B, M), sink rows dropped."""
    return torch.cat([p[:-1].cpu() for p in parts]).numpy()


def dist_stream_sharded_plain(P_blocks, step_block, step_chunk, tables, tri_chunk: int,
                              devices: Sequence):
    """``dist_stream_sharded`` as the plain tile walk of each shard's local
    schedule on its device."""
    devices = [torch.device(d) for d in devices]
    outs = [dist_stream_plain(P, sb, sc, tables, tri_chunk)
            for P, sb, sc in _shards(P_blocks, step_block, step_chunk, tri_chunk, devices)]
    return _gather([o[0] for o in outs]), _gather([o[1] for o in outs])


def wind_stream_sharded_plain(P_blocks, step_block, step_chunk, tables, tri_chunk: int,
                              devices: Sequence) -> np.ndarray:
    """``wind_stream_sharded`` as the plain tile walk (see above)."""
    devices = [torch.device(d) for d in devices]
    return _gather([wind_stream_plain(P, sb, sc, tables, tri_chunk)
                    for P, sb, sc in _shards(P_blocks, step_block, step_chunk, tri_chunk, devices)])


def dist_stream_sharded(P_blocks, step_block, step_chunk, tables, tri_chunk: int,
                        devices: Sequence):
    """dist_stream over a mesh: entry d streams the d-th contiguous range of
    the (B, M, 3) point blocks on its device, with its own copy of the
    packed table, through one dist_kernel launch. Returns host (B, M) numpy
    arrays (d2, best) without the sink row (dist_stream_pallas_sharded's
    contract), bit-equal to rows :B of one dist_stream launch: every point
    sees the same chunks in the same order on the same kernel."""
    devices = [torch.device(d) for d in devices]
    if mesh_kind(devices) == "cpu":
        return dist_stream_sharded_plain(P_blocks, step_block, step_chunk, tables, tri_chunk,
                                         devices)
    with span("sdf.streams.schedule"):
        table = pack_dist_kernel_table(tables, tri_chunk)
    outs = []
    for P, sb, sc in _shards(P_blocks, step_block, step_chunk, tri_chunk, devices):
        outs.append(_dist_launch(P.contiguous(), sb, sc, table, tri_chunk))
        LAUNCHES["dist_stream_sharded"] += 1
    return _gather([o[0] for o in outs]), _gather([o[1] for o in outs])


def wind_stream_sharded(P_blocks, step_block, step_chunk, tables, tri_chunk: int,
                        devices: Sequence) -> np.ndarray:
    """wind_stream over a mesh (see dist_stream_sharded). Returns host (B, M)
    summed solid angles without the sink row."""
    devices = [torch.device(d) for d in devices]
    if mesh_kind(devices) == "cpu":
        return wind_stream_sharded_plain(P_blocks, step_block, step_chunk, tables, tri_chunk,
                                         devices)
    with span("sdf.streams.schedule"):
        table = pack_wind_table(tables, tri_chunk)
    outs = []
    for P, sb, sc in _shards(P_blocks, step_block, step_chunk, tri_chunk, devices):
        outs.append(_wind_launch(P.contiguous(), sb, sc, table, tri_chunk))
        LAUNCHES["wind_stream_sharded"] += 1
    return _gather(outs)
