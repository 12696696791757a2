"""CSV dataset loading + train/val split — counterpart of
sdf_representation_tpu/data/dataset.py (reference dataloader/load_data.py:10-96),
with numpy CSV I/O instead of pandas and a numpy reproduction of sklearn's
``train_test_split``.

Kept semantics:
  * reads uniform.csv / surface.csv / narrow.csv (+ mismatch.csv when
    config.mismatchuse), in the layout pandas writes (a ``,x,y,z,S,nx,ny,nz``
    header whose empty first cell names the row-index column)
  * frames with <= 1 row are dropped from the concat
  * total < 1000 points raises ValueError("Very Less Points")
  * features = all-but-last-4 columns, targets = last 4 (S, nx, ny, nz)
  * the split of ``train_test_split(test_size=config.train_test_split,
    random_state=42)``: with ``perm = RandomState(42).permutation(n)`` the
    validation rows are ``perm[:ceil(test_size * n)]`` and the training rows
    the rest, in that order (sklearn's ShuffleSplit).

The ``pcd`` branch (a bare point CSV with no labels) belongs to the
point-cloud trainer and is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np

from ..sampling.sampler import Frame
from ..utils.constants import RANDOM_SEED_TEST_SPLIT


@dataclasses.dataclass
class SDFDataset:
    train_x: np.ndarray  # (N, d) float32
    train_y: np.ndarray  # (N, 4) float32
    val_x: np.ndarray
    val_y: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.train_x)

    @property
    def n_val(self) -> int:
        return len(self.val_x)


def frame_from_csv(path: str) -> Optional[Frame]:
    """The CSV as a Frame without its row-index column; None when the file
    is missing (cf. load_data.py:92-96)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        columns = f.readline().rstrip("\r\n").split(",")
    values = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2, dtype=np.float64)
    if columns and columns[0] in ("", "Unnamed: 0"):
        columns, values = columns[1:], values[:, 1:]
    return Frame(tuple(columns), values.reshape(-1, len(columns)))


def split_indices(n: int, test_size: float, seed: int = RANDOM_SEED_TEST_SPLIT):
    """(train rows, validation rows) of sklearn's
    ``train_test_split(test_size=test_size, random_state=seed)`` on n rows."""
    n_test = math.ceil(test_size * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size {test_size} leaves an empty split of {n} rows")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def load_data(data_path: str, config) -> SDFDataset:
    if "pcd" in config.name:
        raise NotImplementedError(
            "point-cloud (pcd) datasets belong to the IGR slice of the port: see ROADMAP.md"
        )
    names = ["uniform.csv", "surface.csv", "narrow.csv"]
    frames = [frame_from_csv(os.path.join(data_path, name)) for name in names]
    if config.mismatchuse:
        mismatch = frame_from_csv(os.path.join(data_path, "mismatch.csv"))
        if mismatch is None:
            raise FileNotFoundError(os.path.join(data_path, "mismatch.csv"))
        frames.append(mismatch)

    frames = [f for f in frames if f is not None and len(f) > 1]
    if not frames:
        raise ValueError("Very Less Points")
    if any(f.columns != frames[0].columns for f in frames):
        raise ValueError("the dataset's CSV files have different columns")
    data = np.concatenate([f.values for f in frames], axis=0)
    if len(data) < 1000:
        raise ValueError("Very Less Points")

    X = data[:, :-4].astype(np.float32)
    Y = data[:, -4:].astype(np.float32)
    train, val = split_indices(len(X), config.train_test_split)
    return SDFDataset(
        np.ascontiguousarray(X[train]),
        np.ascontiguousarray(Y[train]),
        np.ascontiguousarray(X[val]),
        np.ascontiguousarray(Y[val]),
    )
