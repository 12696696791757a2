"""Which roundings of the winding's numerator and denominator hold the stream
limits on points that lie ON the surface: a CPU study of wind_kernel's
arithmetic (csrc/sdf_streams.cu) against the plain winding tile.

The table form n_ii - 2 P.v_i + |P|^2 cancels near the surface, so for a
point on a triangle near one of its edges, numer and denom of the triangles
there are rounding noise; a kernel that rounds them otherwise than the plain
version can move that point's solid-angle sum by up to 4 pi. Each variant
below changes one rounding of the plain tile (sdf_streams._wind_tile) and is
summed over the rescaled icosphere(5) (20,480 faces) at points sampled on
its surface, then held against the plain sum at rtol 1e-4 / atol 1e-3:

  poly_atan2        the JAX kernel's polynomial atan2 (sdf_streams.atan2_poly)
  sqrt_next_up      each length one float up (as x * rsqrt(x) may round)
  contracted_denom  denom = fma(lc, fma(la, lb, ab), fma(bc, la, ca lb))
  fma_dots          P.v_i - |P|^2 / 2 and the numerator as FMA chains,
                    |v_i - P|^2 = n_ii - 2 h_i, (v_i - P).(v_j - P) =
                    n_ij - h_i - h_j, with sqrt_next_up and contracted_denom

FMA is emulated in float64 (a product of two floats is exact there). This
runs on the CPU and gives no device number: it says which arithmetic the
kernel may use.

    python3 tools/wind_rounding_study.py [--points 8192] [--out FILE]
"""
import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere  # noqa: E402
from sdf_representation_tpu_torch.geometry.rescale import rescale_mesh  # noqa: E402
from sdf_representation_tpu_torch.ops import sdf_exact as se  # noqa: E402
from sdf_representation_tpu_torch.ops import sdf_streams as ss  # noqa: E402
from sdf_representation_tpu_torch.sampling.sampler import sample_surface_points  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--points", type=int, default=8192)
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--out", default=None)
args = parser.parse_args()

F64 = torch.float64


def fma(a, b, c):
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(torch.float32)


def length(x, next_up):
    y = torch.sqrt(torch.clamp_min(x, 1e-30))
    return torch.nextafter(y, torch.full_like(y, math.inf)) if next_up else y


def half_angles(P, r, poly=False, next_up=False, contract=False, fma_dots=False):
    """(M, T) atan2(numer, denom) of the winding tile, rounded as told."""
    col = lambda k: r[:, k]
    X, Y, Z = P[:, 0:1], P[:, 1:2], P[:, 2:3]
    p2 = ((P[:, 0] * P[:, 0] + P[:, 1] * P[:, 1]) + P[:, 2] * P[:, 2])[:, None]
    if fma_dots:
        nh = -0.5 * p2
        h = [fma(col(3 * i + 2), Z, fma(col(3 * i + 1), Y, fma(col(3 * i), X, nh)))
             for i in range(3)]
        numer = fma(-col(11), Z, fma(-col(10), Y, fma(-col(9), X, col(18))))
        L = [length(fma(torch.tensor(-2.0), h[i], col(12 + i)), next_up) for i in range(3)]
        ab, bc, ca = ((col(15) - h[0]) - h[1], (col(16) - h[1]) - h[2],
                      (col(17) - h[2]) - h[0])
    else:
        pv = [ss._dots(P, r[:, 3 * i:3 * i + 3]) for i in range(4)]
        numer = col(18) - pv[3]
        L = [length((col(12 + i) - 2.0 * pv[i]) + p2, next_up) for i in range(3)]
        ab = ((col(15) - pv[0]) - pv[1]) + p2
        bc = ((col(16) - pv[1]) - pv[2]) + p2
        ca = ((col(17) - pv[2]) - pv[0]) + p2
    if contract:
        denom = fma(L[2], fma(L[0], L[1], ab), fma(bc, L[0], ca * L[1]))
    else:
        denom = L[0] * L[1] * L[2] + ab * L[2] + bc * L[0] + ca * L[1]
    return (ss.atan2_poly if poly else torch.atan2)(numer, denom)


VARIANTS = {
    "poly_atan2": dict(poly=True),
    "sqrt_next_up": dict(next_up=True),
    "contracted_denom": dict(contract=True),
    "fma_dots": dict(next_up=True, contract=True, fma_dots=True),
}

mesh = rescale_mesh(make_icosphere(5, 0.5))
rng = np.random.default_rng(args.seed)
pts = sample_surface_points(mesh, 1, rng, area_weighted=True, total_points=args.points)
P = torch.from_numpy(pts.astype(np.float32))
tables, _ = se._triangle_tables(mesh.vertices, mesh.faces, 1024)
tab = torch.from_numpy(ss.pack_wind_table(tables, 1024))
plain = torch.zeros(len(P))
sums = {name: torch.zeros(len(P)) for name in VARIANTS}
for chunk in tab:
    plain += ss._wind_tile(P, chunk)
    for name, kw in VARIANTS.items():
        sums[name] += (2.0 * half_angles(P, chunk, **kw) * chunk[:, 19]).sum(dim=1)
limit = 1e-3 + 1e-4 * plain.abs()
report = {"points_on_surface": len(P), "faces": len(mesh.faces), "variants": {}}
for name, w in sums.items():
    diff = (w - plain).abs()
    row = {"max_abs_diff": diff.max().item(), "max_diff_over_limit": (diff / limit).max().item(),
           "points_over_limit": int((diff > limit).sum()),
           "points_over_quarter_limit": int((diff > 0.25 * limit).sum())}
    report["variants"][name] = row
    print(f"{name}: {json.dumps(row)}", flush=True)
if args.out:
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
