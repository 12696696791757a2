"""The port's 2-D mode and the rest of its sampler against the JAX
package's, on the CPU. Tolerances:
  * the analytic generators draw from one ``default_rng`` in the same order:
    their arrays are bit-equal;
  * exact labels (occupancy, the mismatch loop) come from two exact-SDF
    implementations: signs equal, distances within rtol 1e-5 / atol 1e-6
    (tests/test_torch_sampler.py);
  * ``evaluate_points`` in float32 against the JAX one: rtol 1e-5 / atol
    1e-6 (float32 matrix products summed in different orders);
  * the contour: the same set of points, except points whose |f| lies within
    1e-6 of CONTOUR_EPS, where the two float32 forwards may fall on either
    side of the threshold.
"""

import os
import types

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from sdf_representation_tpu.evaluations import two_dim as jax_two_dim
from sdf_representation_tpu.geometry.primitives import make_icosphere
from sdf_representation_tpu.models import ImplicitNet as JaxNet
from sdf_representation_tpu.ops import grid_eval as jax_grid_eval
from sdf_representation_tpu.sampling import sampler as jax_sampler
from sdf_representation_tpu_torch import cli
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.data.dataset import frame_from_csv
from sdf_representation_tpu_torch.evaluations import two_dim
from sdf_representation_tpu_torch.geometry.mesh_io import Mesh
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import grid_eval
from sdf_representation_tpu_torch.sampling import sampler

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nets(radius_init=1.0, seed=0):
    """(JAX model, params, the port's module with the same weights): the
    circle config's 4x64 net, skip at layer 2."""
    kw = dict(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0, radius_init=radius_init)
    jm = JaxNet(**kw)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImplicitNet(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _assert_frames_equal(ours, df):
    assert ours.columns == tuple(df.columns)
    np.testing.assert_array_equal(ours.values, df.to_numpy())


@pytest.mark.parametrize("generator", ["generate_points_circle", "generate_analytical_sphere"])
def test_analytic_generators_bit_equal_jax(tmp_path, generator):
    args = (900, 300, 200, 0.1) if generator == "generate_points_circle" else (900, 300, 200)
    (tmp_path / "ours").mkdir()
    (tmp_path / "jax").mkdir()
    ours = getattr(sampler, generator)(*args, save_path=str(tmp_path / "ours"), seed=7)
    theirs = getattr(jax_sampler, generator)(*args, save_path=str(tmp_path / "jax"), seed=7)
    for frame, df in zip(ours, theirs):
        _assert_frames_equal(frame, df)
    # the CSVs read back to the same rows, through the port's reader and pandas
    for name in ("uniform", "surface", "narrow"):
        back = frame_from_csv(str(tmp_path / "ours" / f"{name}.csv"))
        ref = pd.read_csv(tmp_path / "jax" / f"{name}.csv", index_col=0,
                          float_precision="round_trip")
        np.testing.assert_array_equal(back.values, ref.to_numpy())
        np.testing.assert_array_equal(
            pd.read_csv(tmp_path / "ours" / f"{name}.csv", index_col=0,
                        float_precision="round_trip").to_numpy(), ref.to_numpy())


def test_occupancy_signs_equal_jax():
    mesh = make_icosphere(2, 0.5)
    ours = sampler.generate_occupancy(16, Mesh(mesh.vertices, mesh.faces), device="cpu")
    theirs = jax_sampler.generate_occupancy(16, mesh)
    assert ours.columns == tuple(theirs.columns) == ("x", "y", "z", "occupancy")
    np.testing.assert_array_equal(ours.values[:, :3], theirs[["x", "y", "z"]].to_numpy())
    np.testing.assert_array_equal(ours["occupancy"], theirs["occupancy"].to_numpy())
    inside = np.linalg.norm(ours.values[:, :3], axis=1) < 0.45
    assert np.all(ours["occupancy"][inside] == -1) and inside.sum() > 50


def test_mismatch_loop_matches_jax(tmp_path):
    """augment_mismatch_from_postprocess on the port audit's CSV layout
    (header x,y,z, no index) writes the JAX package's labels."""
    mesh = make_icosphere(2, 0.5)
    stl = str(tmp_path / "sphere.stl")
    from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh

    save_mesh(Mesh(mesh.vertices, mesh.faces), stl)
    post = tmp_path / "postprocess"
    post.mkdir()
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 3)).astype(np.float32)
    np.savetxt(post / "mismatching_co-ordinates1.csv", pts, fmt="%.9g", delimiter=",",
               header="x,y,z", comments="")
    for side in ("ours", "jax"):
        (tmp_path / side).mkdir()

    def trainer(side):
        return types.SimpleNamespace(postprocess_save_path=str(post), data_path=str(tmp_path / side),
                                     config=types.SimpleNamespace(geometry=stl),
                                     device=torch.device("cpu"))

    path = sampler.augment_mismatch_from_postprocess(trainer("ours"))
    jpath = jax_sampler.augment_mismatch_from_postprocess(trainer("jax"))
    assert os.path.basename(path) == os.path.basename(jpath) == "mismatch.csv"
    ours, theirs = frame_from_csv(path), pd.read_csv(jpath, index_col=0)
    assert ours.columns == tuple(theirs.columns) == sampler.COLUMNS
    np.testing.assert_array_equal(
        ours.values[:, :3], np.loadtxt(post / "mismatching_co-ordinates1.csv", delimiter=",",
                                       skiprows=1))
    # the JAX package reads the coordinates with pandas' default parser,
    # which may round the last bit of a float64 apart
    np.testing.assert_allclose(ours.values[:, :3], theirs[["x", "y", "z"]].to_numpy(),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(ours["S"], theirs["S"].to_numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(ours["S"]) == np.sign(theirs["S"].to_numpy()))
    n, n_ref = ours.values[:, 4:], theirs[["nx", "ny", "nz"]].to_numpy()
    assert (np.linalg.norm(n - n_ref, axis=1) < 1e-3).mean() > 0.9


@pytest.mark.parametrize("n,chunk", [(2500, 1000), (700, 262144)])
def test_evaluate_points_matches_jax(n, chunk):
    """Chunks with a zero-padded tail (2500 = 2 x 1000 + 500) and one chunk
    of the whole input."""
    jm, params, tm = _nets(seed=1)
    pts = np.random.default_rng(4).uniform(-1, 1, (n, 3)).astype(np.float32)
    ours = grid_eval.evaluate_points(tm, pts, chunk=chunk)
    theirs = jax_grid_eval.evaluate_points(jm.apply, params, pts, chunk=chunk)
    assert ours.dtype == np.float32 and ours.shape == (n,)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # one batch, not chunks: another blocking of the products
        np.testing.assert_allclose(ours, tm(torch.from_numpy(pts)).numpy(), rtol=1e-6, atol=1e-7)
    bf16 = grid_eval.evaluate_points(tm, pts, chunk=chunk, compute_dtype=torch.bfloat16)
    assert bf16.dtype == np.float32 and 0 < np.abs(bf16 - ours).max() < 0.05


def test_evaluate_points_quarters_the_chunk_on_oom(capsys):
    """An out-of-memory chunk is quartered and the sweep retried (JAX
    grid_eval.py:124-133); below 4096 points, and for other errors, it
    raises."""
    _, _, tm = _nets(seed=2)
    pts = np.random.default_rng(5).uniform(-1, 1, (20000, 3)).astype(np.float32)
    sizes = []

    class Limited(torch.nn.Module):
        def __init__(self, limit):
            super().__init__()
            self.net, self.limit = tm, limit

        def forward(self, x):
            sizes.append(x.shape[0])
            if x.shape[0] > self.limit:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
            return self.net(x)

    out = grid_eval.evaluate_points(Limited(5000), pts, chunk=65536)
    assert sizes[0] == 20000 and set(sizes[1:]) == {5000}
    assert "retrying with chunk=5000" in capsys.readouterr().out
    with torch.no_grad():
        np.testing.assert_allclose(out, tm(torch.from_numpy(pts)).numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        grid_eval.evaluate_points(Limited(1000), pts, chunk=65536)

    class Broken(Limited):
        def forward(self, x):
            raise RuntimeError("not a memory error")

    with pytest.raises(RuntimeError, match="not a memory error"):
        grid_eval.evaluate_points(Broken(0), pts, chunk=65536)


def test_contour_matches_jax(tmp_path):
    """two_dim_contour of the port and of the JAX package on the same
    weights (a geometric-init net whose zero set is a closed curve near
    r = sqrt(2/pi))."""
    jm, params, tm = _nets(radius_init=float(np.sqrt(2 / np.pi)))
    sides = {}
    for side in ("ours", "jax"):
        for sub in ("post", "plots"):
            (tmp_path / side / sub).mkdir(parents=True)
        sides[side] = types.SimpleNamespace(
            model=tm if side == "ours" else jm,
            load_model=(lambda best=True: (tm.state_dict(), 3)) if side == "ours"
            else (lambda best=True: ({"params": params}, 3)),
            postprocess_save_path=str(tmp_path / side / "post"),
            plot_save_path=str(tmp_path / side / "plots"))
    dists = two_dim.two_dim_contour(sides["ours"])
    jdists = jax_two_dim.two_dim_contour(sides["jax"])
    ours = pd.read_csv(tmp_path / "ours" / "post" / "contour_distances.csv")
    theirs = pd.read_csv(tmp_path / "jax" / "post" / "contour_distances.csv")
    assert list(ours.columns) == list(theirs.columns) == ["x", "y", "r"]
    assert len(ours) > 100
    np.testing.assert_array_equal(ours["r"].to_numpy(np.float32), dists)
    assert os.path.exists(tmp_path / "ours" / "plots" / "contour_epoch3.png")

    key = lambda df: set(zip(df["x"].to_numpy(np.float32), df["y"].to_numpy(np.float32)))
    differ = key(ours) ^ key(theirs)
    if differ:
        pts = np.array(sorted(differ), np.float32)
        pts = np.column_stack([pts, np.zeros(len(pts), np.float32)])
        f = np.asarray(jm.apply(params, pts))
        assert np.all(np.abs(np.abs(f) - two_dim.CONTOUR_EPS) < 1e-6), f
    if not differ:
        np.testing.assert_array_equal(dists, jdists)
    assert abs(np.median(dists) - np.sqrt(2 / np.pi)) < 0.2


def test_circle_run_end_to_end(tmp_path):
    """The shipped 2-D config, cut to a tiny net and few points, through
    ``python -m sdf_representation_tpu_torch --device cpu``: the circle CSVs
    are generated, training runs, the contour CSV and plot are written (the
    JAX package's tests/test_pcd_and_2d.py checks)."""
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.training import Trainer

    text = open(os.path.join(REPO, "configs", "circle_2d.ini")).read()
    for old, new in (("directory = ./runs/", f"directory = {tmp_path}/runs/"),
                     ("hidden_dim = 64", "hidden_dim = 32"),
                     ("num_hidden_layers = 4", "num_hidden_layers = 2"),
                     ("skip_connection = 2", "skip_connection = 1"),
                     ("lr = 0.001", "lr = 0.003"), ("epochs = 500", "epochs = 30"),
                     ("min_epochs = 50", "min_epochs = 1"), ("batch_size = 4096", "batch_size = 512"),
                     ("uniform_points = 20000", "uniform_points = 3000"),
                     ("surface = 5000", "surface = 500"), ("narrowband = 5000", "narrowband = 500")):
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / "circle.ini"
    ini.write_text(text)
    assert cli.main([str(ini), "--device", "cpu"]) == 0
    trainer = Trainer(Configuration(str(ini)), device="cpu")
    uniform = frame_from_csv(os.path.join(trainer.data_path, "uniform.csv"))
    assert len(uniform) == 3000 and np.all(uniform["z"] == 0)
    files = os.listdir(trainer.plot_save_path)
    assert any(f.startswith("contour_epoch") for f in files)
    df = pd.read_csv(os.path.join(trainer.postprocess_save_path, "contour_distances.csv"))
    assert list(df.columns) == ["x", "y", "r"] and len(df) > 10
    assert abs(df["r"].median() - np.sqrt(2 / np.pi)) < 0.2
