"""Filesystem helpers (copy of sdf_representation_tpu/utils/files.py)."""

import os


def create_directory(path: str) -> str:
    """mkdir -p and return the path (cf. reference utils/files.py:3-10)."""
    os.makedirs(path, exist_ok=True)
    return path
