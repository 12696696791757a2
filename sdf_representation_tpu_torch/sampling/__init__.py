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
