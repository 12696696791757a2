"""The port's own copy of sdf_representation_tpu/utils/constants.py.

Global seeds, kept numerically identical to the reference
(cf. reference utils/constants.py:3-4) so sampled datasets and train/val splits
are reproducible across frameworks."""

RANDOM_SEED_TEST_SPLIT = 42
RANDOM_SEED_DATA_GENERATION = 100
