"""Standalone sampling CLI — counterpart of ``python -m
sdf_representation_tpu.sampling`` (reference data_generator.py:912-939):

    python -m sdf_representation_tpu_torch.sampling geometry.stl \
        --num_uniform 100000 --num_surface 15 --num_narrow_band 15 \
        --dense_width 0.1 [--out DIR] [--area_weighted] [--device cpu]

Writes uniform.csv, surface.csv and narrow.csv under --out, without the
row-index column. The labels are computed on the card unless ``--device
cpu`` is given; with no card and no device it raises.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sdf_representation_tpu_torch.sampling",
        description="Generate signed distance data for a mesh geometry.",
    )
    p.add_argument("geometry", type=str, help="Path to the mesh geometry file")
    p.add_argument("--num_uniform", type=int, default=10)
    p.add_argument("--num_surface", type=int, default=1)
    p.add_argument("--num_narrow_band", type=int, default=1)
    p.add_argument("--dense_width", type=float, default=0.1)
    p.add_argument("--out", type=str, default=".")
    p.add_argument("--area_weighted", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: the card (raises without one)")
    args = p.parse_args(argv)

    from ..utils.device import resolve_device
    from .sampler import generate_signed_distance_data

    device = resolve_device(args.device)
    uniform, surface, narrow = generate_signed_distance_data(
        args.geometry, args.num_uniform, args.num_surface,
        args.num_narrow_band, args.dense_width, area_weighted=args.area_weighted,
        device=device,
    )
    for name, frame in (("uniform", uniform), ("surface", surface), ("narrow", narrow)):
        path = os.path.join(args.out, f"{name}.csv")
        frame.to_csv(path, index=False)
        print(f"wrote {path} ({len(frame)} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
