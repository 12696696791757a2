"""Minimal gmsh .msh reader (ASCII v2.2 and v4.1) — node extraction.

Replaces the reference's gmsh-python dependency
(reference datagenerator/data_generator.py:117-137
`extract_polygon_from_gmsh`: reads every node in tag order and closes the
polygon). The package does not depend on gmsh; the ASCII format is simple
enough to parse directly.

The port's own copy of sdf_representation_tpu/geometry/msh_io.py (numpy
only).
"""

from __future__ import annotations

import numpy as np


def read_msh_nodes(path: str) -> np.ndarray:
    """All mesh nodes in tag order, (N, 3) float64."""
    with open(path, "r", errors="replace") as f:
        lines = [ln.strip() for ln in f]

    # format version
    version = 2.2
    for i, ln in enumerate(lines):
        if ln == "$MeshFormat" and i + 1 < len(lines):
            version = float(lines[i + 1].split()[0])
            break

    try:
        start = lines.index("$Nodes")
        end = lines.index("$EndNodes")
    except ValueError:
        raise ValueError(f"No $Nodes section in {path}")
    body = lines[start + 1 : end]

    nodes = {}
    if version < 4.0:
        n = int(body[0].split()[0])
        for ln in body[1 : 1 + n]:
            tok = ln.split()
            nodes[int(tok[0])] = [float(tok[1]), float(tok[2]), float(tok[3])]
    else:
        header = body[0].split()
        num_blocks = int(header[0])
        i = 1
        for _ in range(num_blocks):
            blk = body[i].split()
            n_in_block = int(blk[3])
            i += 1
            tags = [int(body[i + k]) for k in range(n_in_block)]
            i += n_in_block
            for k in range(n_in_block):
                tok = body[i + k].split()
                nodes[tags[k]] = [float(tok[0]), float(tok[1]), float(tok[2])]
            i += n_in_block
    tags_sorted = sorted(nodes)
    return np.asarray([nodes[t] for t in tags_sorted], dtype=np.float64)


def extract_polygon_from_msh(path: str) -> np.ndarray:
    """2D polygon vertices (closed: first point appended at the end),
    (N+1, 2) — the reference's node-tag-order convention."""
    nodes = read_msh_nodes(path)
    poly = nodes[:, :2]
    return np.vstack([poly, poly[:1]])


def write_msh_polygon(path: str, points_2d: np.ndarray) -> str:
    """Write a closed polygon as a v2.2 ASCII .msh (nodes + line elements) —
    fixture writer for tests."""
    pts = np.asarray(points_2d, dtype=np.float64)
    n = len(pts)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{n}\n")
        for i, p in enumerate(pts):
            f.write(f"{i+1} {p[0]:.9g} {p[1]:.9g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{n}\n")
        for i in range(n):
            f.write(f"{i+1} 1 2 0 0 {i+1} {(i % n)+2 if i < n-1 else 1}\n")
        f.write("$EndElements\n")
    return path
