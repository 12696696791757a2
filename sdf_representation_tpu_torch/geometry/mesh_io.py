"""Dependency-free triangle-mesh I/O (STL / OBJ / PLY) + mesh math.

The port's own copy of sdf_representation_tpu/geometry/mesh_io.py (numpy
only), so the port imports nothing of the JAX package.

The reference leans on trimesh for all mesh handling (reference
executor/executor.py:72, datagenerator/data_generator.py:828). trimesh is not
in the TPU image, and a framework should own its geometry layer anyway — this
module implements the needed subset with pure numpy:

  * STL: binary + ascii read, binary write
  * OBJ: read/write (v/f lines, polygon faces fan-triangulated)
  * PLY: ascii + binary_little_endian read, ascii write
  * derived quantities: face normals, areas, volume (divergence theorem),
    vertex welding (STL soup -> indexed mesh)
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int64

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float64)
        self.faces = np.ascontiguousarray(self.faces, dtype=np.int64)

    @property
    def triangles(self) -> np.ndarray:
        """(F, 3, 3) corner coordinates."""
        return self.vertices[self.faces]

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        t = self.triangles
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        if normalized:
            ln = np.linalg.norm(n, axis=1, keepdims=True)
            n = n / np.maximum(ln, 1e-300)
        return n

    def face_areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1
        )

    @property
    def volume(self) -> float:
        """Signed volume via the divergence theorem (sum of signed tets)."""
        t = self.triangles
        return float(np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6.0)

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    def welded(self, decimals: int = 8) -> "Mesh":
        """Merge coincident vertices (needed after STL soup loads)."""
        key = np.round(self.vertices, decimals)
        _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
        return Mesh(self.vertices[idx], inv[self.faces])

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy())


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------

def _load_stl(path: str) -> Mesh:
    with open(path, "rb") as f:
        head = f.read(5)
    if head[:5] == b"solid":
        # could still be binary with a 'solid' header; sniff for 'facet'
        with open(path, "rb") as f:
            blob = f.read(1024)
        if b"facet" in blob:
            return _load_stl_ascii(path)
    return _load_stl_binary(path)


def _load_stl_binary(path: str) -> Mesh:
    with open(path, "rb") as f:
        f.seek(80)
        head = f.read(4)
        if len(head) < 4:
            raise ValueError(f"Truncated binary STL header: {path}")
        (n,) = struct.unpack("<I", head)
        # validate the declared count against the actual size BEFORE the
        # read: a lying header (fuzzed n=4e9) must not attempt a 200 GB
        # buffer allocation
        avail = os.fstat(f.fileno()).st_size - 84
        if n * 50 > avail:
            raise ValueError(f"Truncated binary STL: {path}")
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
    if data.size != n * 50:
        raise ValueError(f"Truncated binary STL: {path}")
    rec = data.reshape(n, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    return Mesh(verts, faces).welded()


def _load_stl_ascii(path: str) -> Mesh:
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.split()
            if len(s) == 4 and s[0] == "vertex":
                verts.append([float(s[1]), float(s[2]), float(s[3])])
    v = np.asarray(verts, dtype=np.float64)
    if v.size == 0 or len(v) % 3:
        raise ValueError(f"Malformed ascii STL: {path}")
    faces = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
    return Mesh(v, faces).welded()


def _save_stl(mesh: Mesh, path: str) -> None:
    tri = mesh.triangles.astype(np.float32)
    n = mesh.face_normals().astype(np.float32)
    count = len(tri)
    rec = np.zeros((count, 50), dtype=np.uint8)
    rec[:, 0:12] = n.view(np.uint8).reshape(count, 12)
    rec[:, 12:48] = tri.reshape(count, 9).view(np.uint8).reshape(count, 36)
    with open(path, "wb") as f:
        f.write(b"sdf_representation_tpu binary STL".ljust(80, b"\0"))
        f.write(struct.pack("<I", count))
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

def _load_obj(path: str) -> Mesh:
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                s = line.split()
                verts.append([float(s[1]), float(s[2]), float(s[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"OBJ has no vertices: {path}")
    # 0 faces is legal (point-only OBJ); reshape keeps the (F, 3) contract
    return Mesh(
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


def _save_obj(mesh: Mesh, path: str) -> None:
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for face in mesh.faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"No PLY header in {path}")
    header = blob[:end].decode("ascii", errors="replace").splitlines()
    body = blob[end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_dtype, prop_name) or ('list', ct, it, name)])
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", _PLY_TYPES[tok[2]], _PLY_TYPES[tok[3]], tok[4]))
            else:
                elements[-1][2].append((_PLY_TYPES[tok[1]], tok[2]))

    verts = None
    faces: list = []
    if fmt == "ascii":
        lines = body.decode("ascii", errors="replace").split("\n")
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = []
                names = [p[1] for p in props]
                for i in range(count):
                    vals = lines[pos + i].split()
                    rows.append([float(v) for v in vals[: len(props)]])
                verts = np.asarray(rows)[:, [names.index("x"), names.index("y"), names.index("z")]]
            elif name == "face":
                for i in range(count):
                    vals = [int(v) for v in lines[pos + i].split()]
                    n, idx = vals[0], vals[1 : 1 + vals[0]]
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            pos += count
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[1], "<" + p[0]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float64)
            elif name == "face":
                # assume a single list property (vertex_indices)
                lp = [p for p in props if p[0] == "list"][0]
                cnt_dt = np.dtype("<" + lp[1])
                idx_dt = np.dtype("<" + lp[2])
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cnt_dt, count=1, offset=off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(body, dtype=idx_dt, count=n, offset=off)
                    off += idx_dt.itemsize * n
                    for k in range(1, n - 1):
                        faces.append([int(idx[0]), int(idx[k]), int(idx[k + 1])])
            else:
                raise ValueError(f"Unsupported PLY element {name} in {path}")
    else:
        raise ValueError(f"Unsupported PLY format {fmt} in {path}")
    if verts is None:
        raise ValueError(f"PLY has no vertices: {path}")
    return Mesh(verts, np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def _save_ply(mesh: Mesh, path: str) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for face in mesh.faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------

_LOADERS = {".stl": _load_stl, ".obj": _load_obj, ".ply": _load_ply}
_SAVERS = {".stl": _save_stl, ".obj": _save_obj, ".ply": _save_ply}


def _check_loaded(mesh: Mesh, path: str) -> Mesh:
    """Invariants every successful load must satisfy (the role trimesh's
    validation played at reference data_generator.py:828): arrays are
    (V,3)/(F,3), coordinates finite, face indices in range. Violations are
    data errors -> ValueError, so callers (e.g. the distributed sampler's
    corrupt-mesh skip) can handle them uniformly."""
    if mesh.vertices.ndim != 2 or mesh.vertices.shape[1] != 3:
        raise ValueError(f"Malformed mesh {path}: vertex array is not (V, 3)")
    if mesh.faces.ndim != 2 or mesh.faces.shape[1] != 3:
        raise ValueError(f"Malformed mesh {path}: face array is not (F, 3)")
    if mesh.vertices.size and not np.isfinite(mesh.vertices).all():
        raise ValueError(f"Malformed mesh {path}: non-finite vertex coordinates")
    if len(mesh.faces):
        lo, hi = mesh.faces.min(), mesh.faces.max()
        if lo < 0 or hi >= len(mesh.vertices):
            raise ValueError(
                f"Malformed mesh {path}: face index {lo if lo < 0 else hi} "
                f"out of range for {len(mesh.vertices)} vertices"
            )
    return mesh


def load_mesh(path: str) -> Mesh:
    ext = os.path.splitext(path)[1].lower()
    if ext not in _LOADERS:
        raise ValueError(f"Unsupported mesh format '{ext}' ({path})")
    try:
        mesh = _LOADERS[ext](path)
    except (ValueError, OSError, MemoryError):
        raise
    except Exception as exc:
        # parser stumbles on fuzzed input (struct.error, IndexError, KeyError,
        # TypeError from ragged rows, ...) are DATA errors: surface them as
        # ValueError so malformed files never escape as internal exceptions
        raise ValueError(f"Malformed mesh file {path}: {exc!r}") from exc
    return _check_loaded(mesh, path)


def save_mesh(mesh: Mesh, path: str, file_type: Optional[str] = None) -> None:
    ext = ("." + file_type.lower()) if file_type else os.path.splitext(path)[1].lower()
    if ext not in _SAVERS:
        raise ValueError(f"Unsupported mesh format '{ext}' ({path})")
    _SAVERS[ext](mesh, path)
