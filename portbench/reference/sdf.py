"""Plain exact signed distance and normals of points against a triangle mesh.

Written from the textbook, for the benchmark's comparison only, in plain
PyTorch: the closest point on a triangle by Voronoi regions (Ericson,
Real-Time Collision Detection, section 5.1.5), the sign from the generalized
winding number, the sum of the triangles' solid angles by the formula of Van
Oosterom and Strackee (IEEE Trans. Biomed. Eng. 30(2), 1983). Every pair of
point and triangle is visited: no culling, no far-field approximation.

The normal is the SDF's gradient: sign * (p - q) / |p - q| for the closest
point q, or the closest triangle's unit normal where p lies on the surface
(|p - q| <= ``on_surface``). Distances are negative inside.

``dtype`` is the working type: float64 for the reference, a lower type for
the control (the same arithmetic in bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, with 0 where den is 0 (degenerate triangles)."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def closest_points(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Closest point to each p on triangle (a, b, c); all broadcast, last dim 3."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = va + vb + vc
    v_in, w_in = _div(vb, denom), _div(vc, denom)
    q = a + ab * v_in[..., None] + ac * w_in[..., None]
    # the regions in reverse order of Ericson's early returns, so the first wins
    w_bc = _div(d4 - d3, (d4 - d3) + (d5 - d6))
    q = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                    b + (c - b) * w_bc[..., None], q)
    w_ac = _div(d2, d2 - d6)
    q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], a + ac * w_ac[..., None], q)
    q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c.expand_as(q), q)
    v_ab = _div(d1, d1 - d3)
    q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], a + ab * v_ab[..., None], q)
    q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b.expand_as(q), q)
    q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a.expand_as(q), q)
    return q


def solid_angles(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Signed solid angle of each triangle seen from p (Van Oosterom-Strackee)."""
    x, y, z = a - p, b - p, c - p
    lx, ly, lz = x.norm(dim=-1), y.norm(dim=-1), z.norm(dim=-1)
    num = _dot(x, torch.cross(y, z, dim=-1))
    den = lx * ly * lz + _dot(x, y) * lz + _dot(y, z) * lx + _dot(z, x) * ly
    return 2.0 * torch.atan2(num, den)


def signed_distance(points, vertices, faces, *, device, dtype=torch.float64,
                    on_surface: float = 1e-6, pairs_per_block: int = 1 << 24):
    """(sdf (N,), normals (N, 3)) as float64 numpy arrays for (N, 3) points."""
    tri = torch.as_tensor(np.asarray(vertices, np.float64)[np.asarray(faces)],
                          device=device).to(dtype)  # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    n_face = torch.cross(b - a, c - a, dim=-1)
    n_face = n_face / n_face.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    pts = torch.as_tensor(np.asarray(points, np.float64), device=device).to(dtype)
    rows = max(1, pairs_per_block // max(1, len(tri)))
    sdf, normals = [], []
    for lo in range(0, len(pts), rows):
        p = pts[lo:lo + rows, None, :]  # (M, 1, 3)
        q = closest_points(p, a, b, c)  # (M, F, 3)
        d2 = ((p - q) ** 2).sum(-1)
        best = d2.argmin(dim=1)
        m = torch.arange(len(best), device=device)
        q_best, p0 = q[m, best], p[:, 0]
        del q, d2
        omega = solid_angles(p, a, b, c).sum(dim=1)
        inside = omega > 2.0 * math.pi  # winding number above 1/2
        sign = torch.where(inside, -1.0, 1.0).to(dtype)
        diff = p0 - q_best
        dist = diff.norm(dim=-1)
        on = dist <= on_surface
        normal = torch.where(on[:, None], n_face[best],
                             sign[:, None] * diff / dist.clamp_min(1e-30)[:, None])
        sdf.append(sign * dist)
        normals.append(normal)
    return (torch.cat(sdf).double().cpu().numpy(), torch.cat(normals).double().cpu().numpy())
