from .sampler import (
    generate_signed_distance_data,
    generate_signed_distance,
    sample_surface_points,
    sample_narrow_band_points,
    generate_analytical_sphere,
    generate_points_circle,
    generate_occupancy,
    write_signed_distance_mismatch,
    augment_mismatch_from_postprocess,
)
from .sampler2d import generate_signed_distance_2D_msh, polygon_sdf
from .distributed import write_signed_distance_distributed, compute_min_max
