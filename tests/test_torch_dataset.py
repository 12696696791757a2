"""The port's numpy CSV I/O and split against the JAX package's pandas +
sklearn loader: files are readable both ways and the train / validation
split is exactly equal (same rows, same order)."""

import types

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split

from sdf_representation_tpu.data import dataset as jax_dataset
from sdf_representation_tpu_torch.data import dataset
from sdf_representation_tpu_torch.sampling.sampler import COLUMNS, Frame


def _config(**kw):
    base = dict(name="sphere", mismatchuse=False, train_test_split=0.1, geometry="")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _frames(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [Frame(COLUMNS, rng.normal(size=(n, 7))) for n in sizes]


def _assert_same(ours, theirs):
    for field in ("train_x", "train_y", "val_x", "val_y"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,test_size", [(1000, 0.1), (1037, 0.1), (2001, 0.25), (1500, 0.333)])
def test_split_equals_sklearn(n, test_size):
    train, val = dataset.split_indices(n, test_size)
    rows = np.arange(n)
    ref_train, ref_val = train_test_split(rows, test_size=test_size, random_state=42)
    np.testing.assert_array_equal(train, ref_train)
    np.testing.assert_array_equal(val, ref_val)


@pytest.mark.parametrize("writer", ["port", "pandas"])
@pytest.mark.parametrize("mismatch", [False, True])
def test_csvs_readable_both_ways_and_split_exactly_equal(tmp_path, writer, mismatch):
    names = ["uniform.csv", "surface.csv", "narrow.csv"] + (["mismatch.csv"] if mismatch else [])
    for name, frame in zip(names, _frames([700, 400, 300, 120])):
        path = str(tmp_path / name)
        if writer == "port":
            frame.to_csv(path)
        else:
            pd.DataFrame(frame.values, columns=list(COLUMNS)).to_csv(path)
    cfg = _config(mismatchuse=mismatch)
    ours = dataset.load_data(str(tmp_path), cfg)
    theirs = jax_dataset.load_data(str(tmp_path), cfg)
    _assert_same(ours, theirs)
    total = 1400 + (120 if mismatch else 0)
    assert ours.n_val == int(np.ceil(0.1 * total)) and ours.n_train + ours.n_val == total
    assert ours.train_x.shape[1] == 3 and ours.train_y.shape[1] == 4


def test_frame_csv_layout_and_exact_round_trip(tmp_path):
    frame = _frames([5])[0]
    path = tmp_path / "f.csv"
    frame.to_csv(str(path))
    lines = path.read_text().splitlines()
    assert lines[0] == ",x,y,z,S,nx,ny,nz" and lines[1].startswith("0,") and len(lines) == 6
    back = dataset.frame_from_csv(str(path))
    assert back.columns == COLUMNS
    np.testing.assert_array_equal(back.values, frame.values)  # 17 digits: exact
    # pandas' default float parser is fast, not exact (1 ulp of float64)
    df = pd.read_csv(path, float_precision="round_trip")
    assert list(df.columns) == ["Unnamed: 0", *COLUMNS]
    np.testing.assert_array_equal(df[list(COLUMNS)].to_numpy(), frame.values)
    np.testing.assert_allclose(pd.read_csv(path)[list(COLUMNS)].to_numpy(), frame.values,
                               rtol=1e-15)
    # a file without the index column reads the same
    path.write_text("x,y,z,S,nx,ny,nz\n" + "\n".join(ln.split(",", 1)[1] for ln in lines[1:]) + "\n")
    np.testing.assert_array_equal(dataset.frame_from_csv(str(path)).values, frame.values)
    assert dataset.frame_from_csv(str(tmp_path / "absent.csv")) is None


def test_short_frames_dropped_and_too_few_points_refused(tmp_path):
    uniform, surface, one_row = _frames([1200, 1, 1], seed=1)
    uniform.to_csv(str(tmp_path / "uniform.csv"))
    surface.to_csv(str(tmp_path / "surface.csv"))  # <= 1 row: dropped, narrow.csv is missing
    ours = dataset.load_data(str(tmp_path), _config())
    _assert_same(ours, jax_dataset.load_data(str(tmp_path), _config()))
    assert ours.n_train + ours.n_val == 1200
    _frames([999])[0].to_csv(str(tmp_path / "uniform.csv"))
    for load in (dataset.load_data, jax_dataset.load_data):
        with pytest.raises(ValueError, match="Very Less Points"):
            load(str(tmp_path), _config())
    (tmp_path / "uniform.csv").unlink()
    with pytest.raises(ValueError, match="Very Less Points"):
        dataset.load_data(str(tmp_path), _config())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataset.load_data(str(tmp_path), _config(name="bunny_pcd"))
    with pytest.raises(FileNotFoundError):
        dataset.load_data(str(tmp_path), _config(mismatchuse=True))
