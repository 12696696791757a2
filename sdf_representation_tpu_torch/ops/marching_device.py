"""Block-sparse marching tetrahedra on the volume's own device — counterpart
of sdf_representation_tpu/ops/marching_device.py.

The volume never leaves its device: only the surface does. The stages are
the JAX module's, in torch ops:

  1. LIVE BLOCKS: the volume is cut into 8^3-point core blocks; a block is
     live iff its 9^3 corner region (core + 1-point halo) holds both signs
     of ``vol <= level`` (per-core any/all, OR-ed with the 7 +neighbours: a
     superset of the exact straddle, never a miss).
  2. HALO ROWS: the (L, 9^3) values of the L live blocks, clamped at the
     grid's far edges (the JAX edge padding).
  3. EDGE BITS: every tet edge joins g and g + d for one of 7 ascending
     directions d; the pair (lo grid point, d) is a vertex owned by the
     live block whose core holds lo. Each core keeps its 7 live-edge bits
     and its global vertex base (the exclusive prefix of the bit counts
     over cores in live-block order): a vertex id is the base plus the
     popcount of the bits below d.
  4. VERTICES: enumerated core by core, directions ascending, with
     t = (level - va) / (vb - va) in f32 (0.5 where vb == va), clipped.
  5. TRIANGLES (exact wire only): mixed cubes in flat order, their 6 tets,
     each tet's 1-2 triangles from the case table, each edge resolved to
     its owner's vertex id; orientation from marching._FLIP_TABLE.

The vertex and face arrays come out in the JAX module's order, id for id,
and the packed wire's decode rebuilds the same ids from the sign bits. The
JAX stages were shaped by the TPU's slow gathers (word-packed compaction,
cummax segment expansion, static budgets grown in a retry loop); on a card
``nonzero``, ``cumsum``, ``repeat_interleave`` and row gathers enumerate
the same sets at memory bandwidth and size their outputs exactly, so none
of that machinery has a counterpart here. The JAX module's
``MARCH_SORTED_SCATTER`` and ``MARCH_COMPACT`` switches A/B two XLA
strategies with one output and are not ported either. No scatter here has
repeated indices, so the output is the same on every run and device.

Two wires bring the surface to the host:

  ``marching_tets_device``         exact: vertex slots, f32 t, faces.
  ``marching_tets_device_packed``  packed: the live blocks' sign bits in
                                   u32 words (ceil(729/32) per block), t as
                                   round(t * 65535) in u16 and the live
                                   block ids; ``decode_packed_wire`` rebuilds
                                   slots and faces on the host (identical
                                   topology, t within 1/65535 of an edge).

Slots are gid*7 + d with gid the flat grid point: a grid of nx*ny*nz*7 >=
2^31 raises ValueError (ops/giga_extract.py tiles such grids into slabs),
as does a volume with more than 2^24 vertices (``VERTEX_CAP``: the JAX
packed core word ``cvbase << 7 | bits`` is int32), whose message names the
"packed core-word budget" that the giga extractor's retry keys on.
"""

from __future__ import annotations

import os
import time
from typing import Tuple

import numpy as np
import torch

from .marching import _CASE_TRIS, _CORNERS, _FLIP_TABLE, _TET_EDGES, _TETS

# the 7 ascending edge directions; direction index = corner-bit pattern - 1
# (corner id encodes (x,y,z) as x*4+y*2+z, so _CORNERS[1:] enumerates them)
_DIRS = _CORNERS[1:].copy()  # (7, 3)

_B = 8  # core block edge (points); halo region is (B+1)^3
_H = _B + 1
_WORDS = -(-_H ** 3 // 32)  # u32 sign words per live block on the packed wire

# vertices one volume may hold (the JAX packed core word's 2^24 ceiling)
VERTEX_CAP = 1 << 24

def _build_static_tables():
    """ntris (16,) triangles per case, and a PACKED per-(tet, case, k) edge
    table (192,) int32: bits [6j .. 6j+2] = cube-corner id of edge j's low
    endpoint, bits [6j+3 .. 6j+5] = direction index, bit 18 = orientation
    flip (from marching._FLIP_TABLE). lo corner = a & b and direction =
    (a ^ b) - 1 hold because corner ids are bit-packed coordinates and all
    decomposition edges ascend. One gather decodes a whole triangle."""
    ntris = np.zeros(16, np.int32)
    for case_id, tris in _CASE_TRIS.items():
        ntris[case_id] = len(tris)
    ptbl = np.zeros((6, 16, 2), np.int64)
    for tet in range(6):
        for case_id, tris in _CASE_TRIS.items():
            for k, tri in enumerate(tris):
                packed = 0
                for j, e in enumerate(tri):
                    a = _TETS[tet][_TET_EDGES[e][0]]
                    b = _TETS[tet][_TET_EDGES[e][1]]
                    lo = int(a & b)
                    d = int(a ^ b) - 1
                    packed |= lo << (6 * j)
                    packed |= d << (6 * j + 3)
                if _FLIP_TABLE[tet, case_id, k]:
                    packed |= 1 << 18
                ptbl[tet, case_id, k] = packed
    return ntris, ptbl.reshape(192).astype(np.int32)


_NTRIS_NP, _PTBL_NP = _build_static_tables()

_IDX_TABLES = None


def _index_tables():
    """(li, lj, lk, core_flat, hi_flat, corner_flat): per core of a block,
    its local coordinates and its flat index into the 9^3 halo region, of
    itself, of its 7 +d neighbours and of its cube's 8 corners."""
    global _IDX_TABLES
    if _IDX_TABLES is None:
        li, lj, lk = np.meshgrid(
            np.arange(_B), np.arange(_B), np.arange(_B), indexing="ij"
        )
        li, lj, lk = li.ravel(), lj.ravel(), lk.ravel()
        core_flat = (li * _H + lj) * _H + lk
        hi_flat = np.stack(
            [((li + dx) * _H + (lj + dy)) * _H + (lk + dz)
             for dx, dy, dz in _DIRS]
        )
        corner_flat = np.stack(
            [((li + dx) * _H + (lj + dy)) * _H + (lk + dz)
             for dx, dy, dz in _CORNERS]
        )
        _IDX_TABLES = (li, lj, lk, core_flat, hi_flat, corner_flat)
    return _IDX_TABLES


_POP7 = np.array([bin(i).count("1") for i in range(128)], np.uint8)
# ascending set-bit positions per 7-bit value (padded with 0): vectorized
# set-bit enumeration without a python-level nonzero over an (N, 7) blowup
_DPOS7 = np.zeros((128, 7), np.int8)
for _v in range(128):
    _bits = [_d for _d in range(7) if (_v >> _d) & 1]
    _DPOS7[_v, : len(_bits)] = _bits
del _v, _bits
_NTRIS_U8 = _NTRIS_NP.astype(np.uint8)

_DEVICE_TABLES: dict = {}


def _tables(device: torch.device) -> dict:
    """The static tables as int64 tensors on ``device`` (made once per
    device)."""
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        li, lj, lk, core_flat, hi_flat, corner_flat = _index_tables()
        arrays = dict(li=li, lj=lj, lk=lk, core_flat=core_flat, hi_flat=hi_flat,
                      corner_flat=corner_flat, ntris=_NTRIS_NP, ptbl=_PTBL_NP,
                      pop7=_POP7, dpos7=_DPOS7.reshape(-1), tets=_TETS)
        tabs = {k: torch.as_tensor(np.asarray(v, np.int64), device=device)
                for k, v in arrays.items()}
        _DEVICE_TABLES[device] = tabs
    return tabs


def _check_slot_space(shape) -> None:
    nx, ny, nz = shape
    if nx * ny * nz * 7 >= 2**31:
        raise ValueError(
            f"grid {tuple(shape)} exceeds the int32 slot space (max ~645^3)"
        )


def _pad_edge(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``a`` grown to ``size`` along ``axis`` by repeating its last plane
    (the JAX ``jnp.pad(mode="edge")``)."""
    extra = size - a.shape[axis]
    if extra <= 0:
        return a
    last = a.narrow(axis, a.shape[axis] - 1, 1)
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat([a, last.expand(shape)], dim=axis)


def _any_blocks(sb: torch.Tensor) -> torch.Tensor:
    return sb.any(dim=5).any(dim=3).any(dim=1)


def _union_fwd(x: torch.Tensor) -> torch.Tensor:
    """x OR-ed with its 7 +d neighbours (False past the far faces)."""
    u = x.clone()
    nbx, nby, nbz = x.shape
    for dx, dy, dz in _DIRS:
        u[: nbx - dx, : nby - dy, : nbz - dz] |= x[dx:, dy:, dz:]
    return u


class _Stages:
    """Stages 1-4 over one volume: live blocks, halo rows, edge bits,
    vertices. Holds device tensors; every count the host needs is read
    with one ``.item()``."""

    def __init__(self, vol: torch.Tensor, level: float):
        if vol.dim() != 3:
            raise ValueError(f"volume must be 3-d, got shape {tuple(vol.shape)}")
        vol = vol.detach().to(torch.float32).contiguous()
        dev = vol.device
        self.tabs = tabs = _tables(dev)
        self.lvl = lvl = torch.tensor(level, dtype=torch.float32, device=dev)
        nx, ny, nz = self.shape = tuple(vol.shape)
        nbx, nby, nbz = -(-nx // _B), -(-ny // _B), -(-nz // _B)
        self.nb = (nbx, nby, nbz)
        self.nb3 = nbx * nby * nbz

        # ---- 1. live blocks -------------------------------------------------
        s = vol <= lvl  # inside mask; the same predicate everywhere
        sp = _pad_edge(_pad_edge(_pad_edge(s, 0, nbx * _B), 1, nby * _B), 2, nbz * _B)
        sb = sp.view(nbx, _B, nby, _B, nbz, _B)
        live = _union_fwd(_any_blocks(sb)) & _union_fwd(_any_blocks(~sb))
        del s, sp, sb
        self.bids = bids = torch.nonzero(live.reshape(-1)).flatten()  # ascending
        self.L = L = bids.numel()
        bx, by, bz = bids // (nby * nbz), (bids // nbz) % nby, bids % nbz
        self.gx0, self.gy0, self.gz0 = bx * _B, by * _B, bz * _B

        # ---- 2. halo rows (far edges clamped: the JAX edge padding) ---------
        ar = torch.arange(_H, device=dev)
        hx = (self.gx0[:, None] + ar).clamp_(max=nx - 1)
        hy = (self.gy0[:, None] + ar).clamp_(max=ny - 1)
        hz = (self.gz0[:, None] + ar).clamp_(max=nz - 1)
        flat = (hx[:, :, None, None] * ny + hy[:, None, :, None]) * nz + hz[:, None, None, :]
        self.volg = volg = vol.reshape(-1)[flat.reshape(L, _H ** 3)]  # (L, 729)
        del flat
        self.sgb = sgb = volg <= lvl

        # ---- 3. per-core live-edge bits and vertex bases --------------------
        gxc = self.gx0[:, None] + tabs["li"]
        gyc = self.gy0[:, None] + tabs["lj"]
        gzc = self.gz0[:, None] + tabs["lk"]
        okx0, okx1 = gxc <= nx - 1, gxc <= nx - 2
        oky0, oky1 = gyc <= ny - 1, gyc <= ny - 2
        okz0, okz1 = gzc <= nz - 1, gzc <= nz - 2
        self.cube_ok = okx1 & oky1 & okz1
        s_lo = sgb[:, tabs["core_flat"]]  # (L, 512)
        bits = torch.zeros((L, _B ** 3), dtype=torch.int64, device=dev)
        for d, (dx, dy, dz) in enumerate(_DIRS):
            ld = s_lo != sgb[:, tabs["hi_flat"][d]]
            ok = (okx1 if dx else okx0) & (oky1 if dy else oky0) & (okz1 if dz else okz0)
            bits |= (ld & ok).long() << d
        self.lf = lf = bits.reshape(-1)  # (L*512,) 7-bit edge masks, core-major
        ncf = tabs["pop7"][lf]
        excl = torch.cumsum(ncf, 0)
        self.count_v = count_v = int(excl[-1].item()) if L else 0
        if count_v > VERTEX_CAP:
            raise ValueError(
                f"{count_v} vertices overflow the packed core-word budget "
                "(2^24); extract in sub-volumes (ops/giga_extract)"
            )
        self.cvbase = excl - ncf  # exclusive global vertex base per core

        # ---- 4. vertices: core-major, directions ascending ------------------
        core = torch.nonzero(lf).flatten()
        n_core = ncf[core]
        core_v = torch.repeat_interleave(core, n_core, output_size=count_v)
        rank = torch.arange(count_v, device=dev) - torch.repeat_interleave(
            self.cvbase[core], n_core, output_size=count_v)
        self.d_v = d_v = tabs["dpos7"][lf[core_v] * 7 + rank]
        self.row_v = row_v = core_v // (_B ** 3)
        lflat = core_v % (_B ** 3)
        self.lx_v, self.ly_v, self.lz_v = lflat // 64, (lflat // 8) % 8, lflat % 8

    def t(self) -> torch.Tensor:
        """(V,) f32 edge parameters, the JAX arithmetic."""
        d1 = self.d_v + 1
        lx, ly, lz = self.lx_v, self.ly_v, self.lz_v
        lo_h = (lx * _H + ly) * _H + lz
        hi_h = ((lx + (d1 >> 2)) * _H + (ly + ((d1 >> 1) & 1))) * _H + (lz + (d1 & 1))
        base = self.row_v * _H ** 3
        volg = self.volg.reshape(-1)
        va, vb = volg[base + lo_h], volg[base + hi_h]
        denom = vb - va
        t = torch.where(denom != 0, (self.lvl - va) / denom, torch.full_like(va, 0.5))
        return t.clamp(0.0, 1.0)

    def vslots(self) -> torch.Tensor:
        """(V,) int64 slots gid*7 + d."""
        nx, ny, nz = self.shape
        g = ((self.gx0[self.row_v] + self.lx_v) * ny + self.gy0[self.row_v] + self.ly_v) * nz
        return (g + self.gz0[self.row_v] + self.lz_v) * 7 + self.d_v

    def faces(self) -> torch.Tensor:
        """(T, 3) int64 faces: mixed cubes in flat order, tets in order,
        each tet's triangles in case-table order."""
        tabs, L, dev = self.tabs, self.L, self.bids.device
        _, nby, nbz = self.nb
        inside = self.sgb[:, tabs["corner_flat"]]  # (L, 8, 512)
        csum = inside.sum(dim=1)
        mixed = ((csum > 0) & (csum < 8) & self.cube_ok).reshape(-1)
        cand = torch.nonzero(mixed).flatten()  # ascending flat cube ids
        corners = inside.permute(0, 2, 1).reshape(-1, 8)[cand].long()  # (M, 8)
        weights = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)
        case = (corners[:, tabs["tets"]] * weights).sum(-1)  # (M, 6)
        ntr = tabs["ntris"][case]
        slot = torch.arange(2, device=dev) < ntr[:, :, None]  # (M, 6, 2)
        tri = torch.nonzero(slot.reshape(-1)).flatten()
        m_t, tet_t, k_t = tri // 12, (tri // 2) % 6, tri % 2
        pt = tabs["ptbl"][(tet_t * 16 + case.reshape(-1)[m_t * 6 + tet_t]) * 2 + k_t]

        cube = cand[m_t]
        bid = self.bids[cube // (_B ** 3)]
        lcube = cube % (_B ** 3)
        bx, by, bz = bid // (nby * nbz), (bid // nbz) % nby, bid % nbz
        lx, ly, lz = lcube // 64, (lcube // 8) % 8, lcube % 8
        inv = torch.full((self.nb3,), -1, dtype=torch.int64, device=dev)
        inv[self.bids] = torch.arange(L, device=dev)
        cols, owners = [], []
        for j in range(3):
            lo_c = (pt >> (6 * j)) & 7
            d_e = (pt >> (6 * j + 3)) & 7
            lxe, lye, lze = lx + (lo_c >> 2), ly + ((lo_c >> 1) & 1), lz + (lo_c & 1)
            owner = inv[((bx + (lxe >> 3)) * nby + (by + (lye >> 3))) * nbz + (bz + (lze >> 3))]
            owners.append(owner)
            ci = owner * (_B ** 3) + ((lxe & 7) * 8 + (lye & 7)) * 8 + (lze & 7)
            below = self.lf[ci] & ((1 << d_e) - 1)
            cols.append(self.cvbase[ci] + tabs["pop7"][below])
        if len(pt) and bool((torch.stack(owners) < 0).any()):
            raise RuntimeError("device march: an edge's owner block is not live")
        flip = ((pt >> 18) & 1) == 1
        f0 = torch.where(flip, cols[2], cols[0])
        f2 = torch.where(flip, cols[0], cols[2])
        return torch.stack([f0, cols[1], f2], dim=1)

    def packed(self):
        """The packed wire as host arrays: (sign words (L, 23) u32, t_q (V,)
        u16, live block ids (L,) int32)."""
        dev = self.bids.device
        pad = torch.zeros((self.L, _WORDS * 32 - _H ** 3), dtype=torch.bool, device=dev)
        bits = torch.cat([self.sgb, pad], dim=1).view(self.L, _WORDS, 32).long()
        words = (bits << torch.arange(32, device=dev)).sum(-1)
        # u32 and u16 travel as the int32 / int16 with the same bits
        words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
        t_q = torch.round(self.t() * 65535.0).to(torch.int32)
        t_q = torch.where(t_q >= 2**15, t_q - 2**16, t_q).to(torch.int16)
        return (words.cpu().numpy().view(np.uint32), t_q.cpu().numpy().view(np.uint16),
                self.bids.to(torch.int32).cpu().numpy())


def marching_tets_device(vol: torch.Tensor, level: float = 0.0):
    """The exact wire: march ``vol`` on its device and return host arrays
    (vslots (V,) int64, t (V,) float64, faces (T, 3) int64). vslots encodes
    (grid point gid)*7 + direction; decode with ``decode_vertices``."""
    _check_slot_space(vol.shape)
    st = _Stages(vol, level)
    if st.L == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float64), np.zeros((0, 3), np.int64)
    vslots, t, faces = st.vslots(), st.t(), st.faces()
    return (vslots.cpu().numpy(), t.cpu().numpy().astype(np.float64),
            faces.cpu().numpy())


_WIRE_LIB = None  # None = untried; False = unavailable; else bound CDLL


def _get_wire_lib():
    """The native packed-wire decoder (native/src/wire_decode.cpp) inside
    libsdfnet_c.so (``export.native_runtime.default_lib_path``), or None.
    The numpy decode below is the reference implementation and the
    fallback; SDF_WIRE_DECODE=numpy forces it (the parity tests A/B the
    two). SDF_WIRE_LIB overrides the library path."""
    global _WIRE_LIB
    if _WIRE_LIB is not None:
        return _WIRE_LIB or None
    if os.environ.get("SDF_WIRE_DECODE", "native") != "native":
        _WIRE_LIB = False
        return None
    import ctypes

    from ..export.native_runtime import default_lib_path

    path = os.environ.get("SDF_WIRE_LIB", default_lib_path())
    try:
        lib = ctypes.CDLL(path)
        lib.sdfnet_wire_decode  # older builds lack the symbol
    except (OSError, AttributeError):
        _WIRE_LIB = False
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sdfnet_wire_decode.restype = ctypes.c_void_p
    lib.sdfnet_wire_decode.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int32, i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, i64p, i64p,
    ]
    lib.sdfnet_wire_fetch.restype = ctypes.c_int
    lib.sdfnet_wire_fetch.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.sdfnet_wire_free.argtypes = [ctypes.c_void_p]
    lib.sdfnet_wire_last_error.restype = ctypes.c_char_p
    _WIRE_LIB = lib
    return lib


def wire_decoder() -> str:
    """"native" or "numpy": the decoder ``decode_packed_wire`` runs."""
    return "native" if _get_wire_lib() is not None else "numpy"


def _decode_packed_wire_native(words, t_q, bids, shape):
    """decode_packed_wire through the C++ decoder; None if unavailable.
    Same tables, same arithmetic, same enumeration order — outputs are
    np.array_equal with the numpy path (tests/test_torch_marching_device.py)."""
    lib = _get_wire_lib()
    if lib is None:
        return None
    import ctypes

    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    w = np.ascontiguousarray(np.asarray(words, np.uint32))
    bids64 = np.ascontiguousarray(np.asarray(bids, np.int64))
    tabs = [np.ascontiguousarray(a.astype(np.int32)) for a in
            (_DIRS, _CORNERS, _TETS, _NTRIS_NP, _PTBL_NP)]
    vc, tc = ctypes.c_int64(0), ctypes.c_int64(0)
    h = lib.sdfnet_wire_decode(
        w.ctypes.data_as(u32p), len(bids64), w.shape[1],
        bids64.ctypes.data_as(i64p),
        int(shape[0]), int(shape[1]), int(shape[2]),
        *(a.ctypes.data_as(i32p) for a in tabs),
        ctypes.byref(vc), ctypes.byref(tc),
    )
    if not h:
        raise RuntimeError(
            f"native wire decode: {lib.sdfnet_wire_last_error().decode()}"
        )
    try:
        vslots = np.empty(vc.value, np.int64)
        faces = np.empty((tc.value, 3), np.int64)
        lib.sdfnet_wire_fetch(
            h, vslots.ctypes.data_as(i64p), faces.ctypes.data_as(i64p)
        )
    finally:
        lib.sdfnet_wire_free(h)
    return vslots, np.asarray(t_q, np.float64) / 65535.0, faces


def decode_packed_wire(words, t_q, bids, shape):
    """Rebuild (vslots, t, faces) from the packed wire (host, vectorized).

    The wire carries ONLY the per-live-block sign bits (~1 bit/sample),
    u16-quantized edge parameters, and the live block ids; every vertex id
    and face index is a pure function of the sign bits, recomputed here
    with the same arithmetic as the device stages — topology is exactly
    equal to the exact wire, vertex positions within the u16 quantum
    (1/65535 of a cell edge). Role match: the STL deliverable fetch of
    reference executor/executor.py:388-400.

    Layout: the per-core sweep runs in uint8/int32, sign bits expand via
    np.unpackbits, vertices enumerate through the _DPOS7 set-bit-position
    table, and tet cases stay in six per-tet uint8 arrays gathered per
    mixed cube. The C++ decoder (``_get_wire_lib``) takes over where it is
    built."""
    nx, ny, nz = (int(v) for v in shape)
    nbx, nby, nbz = -(-nx // _B), -(-ny // _B), -(-nz // _B)
    nb3 = nbx * nby * nbz
    li, lj, lk, core_flat, hi_flat, corner_flat = _index_tables()
    li32 = li.astype(np.int32)
    lj32 = lj.astype(np.int32)
    lk32 = lk.astype(np.int32)
    bids = np.asarray(bids, np.int64)
    L = len(bids)
    if L == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.float64),
                np.zeros((0, 3), np.int64))
    native = _decode_packed_wire_native(words, t_q, bids, shape)
    if native is not None:
        return native
    w = np.ascontiguousarray(np.asarray(words, np.uint32))
    # little-endian uint32 words: flattened halo bit k == unpacked bit k
    sgb = np.unpackbits(
        w.view(np.uint8), axis=1, bitorder="little"
    )[:, : _H * _H * _H]  # (L, 729) uint8 in {0, 1}

    bx = (bids // (nby * nbz)).astype(np.int32)
    by = ((bids // nbz) % nby).astype(np.int32)
    bz = (bids % nbz).astype(np.int32)

    # ---- per-core live-edge bitmasks (same masks as the device) ----
    gxc = (bx * _B)[:, None] + li32[None, :]
    gyc = (by * _B)[:, None] + lj32[None, :]
    gzc = (bz * _B)[:, None] + lk32[None, :]
    okx0, okx1 = gxc <= nx - 1, gxc <= nx - 2
    oky0, oky1 = gyc <= ny - 1, gyc <= ny - 2
    okz0, okz1 = gzc <= nz - 1, gzc <= nz - 2
    s_lo = sgb[:, core_flat]
    Lbits = np.zeros((L, 512), np.uint8)
    for d, (dx, dy, dz) in enumerate(_DIRS):
        ld = s_lo != sgb[:, hi_flat[d]]
        ok_d = ((okx1 if dx else okx0) & (oky1 if dy else oky0)
                & (okz1 if dz else okz0))
        Lbits += (ld & ok_d).astype(np.uint8) * np.uint8(1 << d)
    lf = Lbits.reshape(-1)  # (L*512,) uint8

    # ---- vertices: row-major (core, direction) enumeration == the
    # device's vertex order, so t_q[k] belongs to vertex k ----
    nz_core = np.flatnonzero(lf)  # ascending -> core-major order preserved
    lf_nz = lf[nz_core]
    ncf_nz = _POP7[lf_nz]
    sel = np.arange(7, dtype=np.uint8)[None, :] < ncf_nz[:, None]
    d_v = _DPOS7[lf_nz][sel].astype(np.int64)  # (V,)
    core_idx = np.repeat(nz_core, ncf_nz)
    row_v = core_idx // 512
    lflat = core_idx % 512
    bid_v = bids[row_v]
    lxv, lyv, lzv = lflat // 64, (lflat // 8) % 8, lflat % 8
    gxv = (bid_v // (nby * nbz)) * _B + lxv
    gyv = ((bid_v // nbz) % nby) * _B + lyv
    gzv = (bid_v % nbz) * _B + lzv
    vslots = ((gxv * ny + gyv) * nz + gzv) * 7 + d_v
    # global exclusive vertex prefix per core (values < 2^24 by the
    # VERTEX_CAP guard, so int32 is exact)
    ncf = _POP7[lf]
    cvbase = np.cumsum(ncf, dtype=np.int32) - ncf

    # ---- mixed cubes + triangle enumeration ----
    # a cube emits triangles only if its 8 corners are mixed: tet cases are
    # computed only at those candidates (~surface count)
    inside = [sgb[:, corner_flat[c]] for c in range(8)]  # uint8 {0,1}
    csum = np.zeros((L, 512), np.uint8)
    for c in range(8):
        csum += inside[c]
    cube_ok = okx1 & oky1 & okz1
    mixed = ((csum > 0) & (csum < 8) & cube_ok).reshape(-1)
    cand = np.flatnonzero(mixed)  # ascending flat cube ids
    inside_c = [inside[c].reshape(-1)[cand] for c in range(8)]
    case_tet = []
    ntr_cand = np.zeros(len(cand), np.uint8)
    for tet in range(6):
        cs = np.zeros(len(cand), np.uint8)
        for bit, corner in enumerate(_TETS[tet]):
            cs += inside_c[int(corner)] * np.uint8(1 << bit)
        case_tet.append(cs)
        ntr_cand += _NTRIS_U8[cs]
    sel_t = np.flatnonzero(ntr_cand)
    reps = ntr_cand[sel_t].astype(np.int64)
    count_t = int(reps.sum())
    if count_t == 0:
        return (vslots.astype(np.int64),
                np.asarray(t_q, np.float64) / 65535.0,
                np.zeros((0, 3), np.int64))
    tri_cand = np.repeat(sel_t, reps).astype(np.int32)  # index into cand
    tri_cube = cand[tri_cand]
    offs = np.repeat((np.cumsum(reps) - reps).astype(np.int32), reps)
    rtri = np.arange(count_t, dtype=np.int32) - offs
    low = np.zeros(count_t, np.int32)
    tet_t = np.zeros(count_t, np.uint8)
    k_t = np.zeros(count_t, np.uint8)
    case_t = np.zeros(count_t, np.uint8)
    for tet in range(6):
        ct = case_tet[tet][tri_cand]
        nt = _NTRIS_U8[ct].astype(np.int32)
        hit = (rtri >= low) & (rtri < low + nt)
        tet_t = np.where(hit, np.uint8(tet), tet_t)
        k_t = np.where(hit, (rtri - low).astype(np.uint8), k_t)
        case_t = np.where(hit, ct, case_t)
        low = low + nt
    pt = _PTBL_NP[
        (tet_t.astype(np.int32) * 16 + case_t) * 2 + k_t
    ]  # int32

    # ---- emission (int32 throughout; all values < 2^31) ----
    inv = np.full(nb3, -1, np.int32)
    inv[bids] = np.arange(L, dtype=np.int32)
    bid_t = bids[tri_cube // 512].astype(np.int32)
    lcube = (tri_cube % 512).astype(np.int32)
    bx_t = bid_t // (nby * nbz)
    by_t = (bid_t // nbz) % nby
    bz_t = bid_t % nbz
    lx_t, ly_t, lz_t = lcube // 64, (lcube // 8) % 8, lcube % 8
    cols = []
    for j in range(3):
        lo_c = (pt >> (6 * j)) & 7
        d_e = (pt >> (6 * j + 3)) & 7
        cx, cy, cz = lo_c >> 2, (lo_c >> 1) & 1, lo_c & 1
        lxe, lye, lze = lx_t + cx, ly_t + cy, lz_t + cz
        owner = inv[((bx_t + (lxe >> 3)) * nby + (by_t + (lye >> 3))) * nbz
                    + (bz_t + (lze >> 3))]
        if (owner < 0).any():
            raise RuntimeError("packed wire: an edge's owner block is not live")
        ci = owner * 512 + ((lxe & 7) * 8 + (lye & 7)) * 8 + (lze & 7)
        bitsw = lf[ci].astype(np.int32)
        rank = _POP7[bitsw & ((np.int32(1) << d_e) - 1)]
        cols.append(cvbase[ci] + rank)
    flips = (pt >> 18) & 1
    f0 = np.where(flips == 1, cols[2], cols[0])
    f2 = np.where(flips == 1, cols[0], cols[2])
    faces = np.stack([f0, cols[1], f2], axis=1).astype(np.int64)
    t = np.asarray(t_q, np.float64) / 65535.0
    return vslots.astype(np.int64), t, faces


def packed_wire(vol: torch.Tensor, level: float = 0.0):
    """The device half of the packed wire: march ``vol`` through stages 1-4
    and return host arrays (sign words (L, 23) u32, t_q (V,) u16, live block
    ids (L,) int32); their copy to the host waits for the device."""
    _check_slot_space(vol.shape)
    st = _Stages(vol, level)
    if st.L == 0:
        return np.zeros((0, _WORDS), np.uint32), np.zeros(0, np.uint16), np.zeros(0, np.int32)
    return st.packed()


def unpack_wire(wire, shape):
    """The host half of the packed wire: (vslots, t, faces) from
    ``packed_wire``'s arrays for a volume of ``shape``."""
    words, t_q, bids = wire
    vslots, t, faces = decode_packed_wire(words, t_q, bids, tuple(shape))
    if len(vslots) != len(t_q):
        raise RuntimeError(f"packed wire: decoded {len(vslots)} vertices, the device sent {len(t_q)}")
    return vslots, t, faces


def marching_tets_device_packed(vol: torch.Tensor, level: float = 0.0, stages=None):
    """The packed wire: the device runs stages 1-4 only, the host fetches
    sign bits + u16 t + block ids and rebuilds vertex ids and faces with
    ``decode_packed_wire``. Returns (vslots (V,) int64, t (V,) float64,
    faces (T, 3) int64, wire_bytes). A dict given as ``stages`` receives the
    host-clock seconds of both halves: "march" (the device stages and the
    wire's copy) and "decode" (the host rebuild)."""
    t0 = time.perf_counter()
    wire = packed_wire(vol, level)
    t1 = time.perf_counter()
    vslots, t, faces = unpack_wire(wire, vol.shape)
    if stages is not None:
        stages.update(march=t1 - t0, decode=time.perf_counter() - t1)
    return vslots, t, faces, sum(a.nbytes for a in wire)


def decode_vertices(
    vslots: np.ndarray,
    t: np.ndarray,
    shape: Tuple[int, int, int],
    spacing,
    origin,
) -> np.ndarray:
    """Unpack (slot, t) -> world-space vertex positions (host, vectorized)."""
    _, ny, nz = shape
    gid = vslots // 7
    d = vslots % 7
    lo = np.stack([gid // (ny * nz), (gid // nz) % ny, gid % nz], axis=1)
    pos = lo.astype(np.float64) + t[:, None] * _DIRS[d].astype(np.float64)
    return pos * np.asarray(spacing, np.float64) + np.asarray(origin, np.float64)


def drop_degenerate(faces: np.ndarray) -> np.ndarray:
    """The faces whose three vertex ids differ."""
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return faces[ok]


def marching_cubes_device(vol: torch.Tensor, level, spacing, origin, wire: str = "exact",
                          stages=None):
    """Device-volume frontend with the host path's return contract:
    (vertices (V, 3) float64 world coords, faces (F, 3) int64).

    wire="exact" fetches f32 t and device-emitted faces (the same triangle
    soup as the host path, up to order). wire="packed" ships sign bits +
    u16 t and rebuilds topology on the host (identical faces and vertex
    ids, vertex positions within 1/65535 of a cell edge); a dict given as
    ``stages`` then receives its halves' seconds
    (``marching_tets_device_packed``)."""
    if wire not in ("exact", "packed"):
        raise ValueError(f"wire={wire!r}")
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    if wire == "packed":
        vslots, t, faces, _ = marching_tets_device_packed(vol, level, stages)
    else:
        vslots, t, faces = marching_tets_device(vol, level)
    verts = decode_vertices(vslots, t, tuple(vol.shape), spacing, origin)
    return verts, drop_degenerate(faces)
