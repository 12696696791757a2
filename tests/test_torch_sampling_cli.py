"""`python -m sdf_representation_tpu_torch.sampling` against `python -m
sdf_representation_tpu.sampling` on a small icosphere, the port with
``--device cpu`` (the streams' plain versions). Both write the three CSVs
without the index column; the sampled points are bit-identical (the same
``default_rng`` draws) and the labels agree within the limits of
tests/test_torch_sdf_exact.py: rtol 1e-5 / atol 1e-6 on the distance, equal
signs off the surface."""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

from sdf_representation_tpu.sampling.__main__ import main as jax_main
from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.sampling.__main__ import main

torch.set_num_threads(2)
HEADER = "x,y,z,S,nx,ny,nz"


def _args(stl, out, area_weighted):
    return [str(stl), "--num_uniform", "700", "--num_surface", "3", "--num_narrow_band", "2",
            "--dense_width", "0.05", "--out", str(out)] + ["--area_weighted"] * area_weighted


@pytest.mark.parametrize("area_weighted", [False, True])
def test_cli_csvs_equal_jax(tmp_path, monkeypatch, capsys, area_weighted):
    stl = tmp_path / "sphere.stl"
    save_mesh(make_icosphere(2, 0.5), str(stl))
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    assert main(_args(stl, ours, area_weighted) + ["--device", "cpu"]) == 0
    assert f"wrote {ours / 'uniform.csv'} (700 points)" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["sampling"] + _args(stl, theirs, area_weighted))
    jax_main()
    for name, rows in (("uniform", 700), ("surface", 320 * 3), ("narrow", 320 * 2)):
        assert (ours / f"{name}.csv").read_text().splitlines()[0] == HEADER  # no index column
        got, want = (pd.read_csv(d / f"{name}.csv", float_precision="round_trip")
                     for d in (ours, theirs))
        assert list(got.columns) == list(want.columns) and len(got) == len(want) == rows
        np.testing.assert_array_equal(got[["x", "y", "z"]], want[["x", "y", "z"]])
        S, S_ref = got["S"].to_numpy(), want["S"].to_numpy()
        np.testing.assert_allclose(S, S_ref, rtol=1e-5, atol=1e-6)
        off = np.abs(S_ref) > 1e-5
        assert np.all(np.sign(S[off]) == np.sign(S_ref[off]))
        n, n_ref = got[["nx", "ny", "nz"]].to_numpy(), want[["nx", "ny", "nz"]].to_numpy()
        assert (np.linalg.norm(n - n_ref, axis=1) < 1e-3).mean() > 0.9


def test_cli_needs_a_card_or_cpu(tmp_path):
    stl = tmp_path / "sphere.stl"
    save_mesh(make_icosphere(1, 0.5), str(stl))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([str(stl), "--out", str(tmp_path)])
    assert not (tmp_path / "uniform.csv").exists()
