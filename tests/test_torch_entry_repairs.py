"""Five repairs of the port's entry points, each against the behaviour of
the JAX package (or, for the build cache, against what a rebuild needs):

  * the audit shards its exact distances over the trainer's mesh
    (JAX post_process.py:91-97), with the single-device values bit for bit;
  * with ``--device cpu`` and no ``--compute-dtype``, reconstruction and the
    audit evaluate densely in f32, as the JAX package does on a CPU backend
    (reconstruct.py:71-91, post_process.py:71-82): the mesh and the audit's
    predicted field match the JAX CPU path's at the tolerances of
    test_torch_reconstruct_e2e.py;
  * ``train_matmul_precision`` takes the names ``jax.default_matmul_precision``
    takes, set for the step and restored after it, and raises for others;
  * ``[TPU] debug_nans = True`` turns on anomaly detection (the JAX
    Trainer's ``jax_debug_nans``): a backward that makes a NaN raises;
  * the build cache's key covers the headers a source includes."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from sdf_representation_tpu.evaluations.reconstruct import reconstruct_mesh as jax_reconstruct
from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.ops.grid_eval import evaluate_points as jax_evaluate_points
from sdf_representation_tpu.ops.grid_eval import grid_coords as jax_grid_coords
from sdf_representation_tpu_torch import kernels
from sdf_representation_tpu_torch.cli import main
from sdf_representation_tpu_torch.configgen import Configuration
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.evaluations import post_process, reconstruct
from sdf_representation_tpu_torch.geometry.mesh_io import save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_icosphere
from sdf_representation_tpu_torch.ops import sdf_exact, sdf_streams
from sdf_representation_tpu_torch.training import Trainer
from sdf_representation_tpu_torch.training.checkpoint import save_checkpoint
from sdf_representation_tpu_torch.training.trainer import make_train_step

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _config(root, **changes):
    """tests/test_config.ini at a 4x64 geometric-init net, with ``changes``
    (keys of the file's own lines) and extra ``[TPU]`` lines (``tpu=``)."""
    tpu = changes.pop("tpu", "")
    text = (REPO / "tests/test_config.ini").read_text().replace("@DIR@", str(root))
    base = {"hidden_dim": 64, "num_hidden_layers": 4, "skip_connection": 2, "beta": 100,
            "geometric_init": True, "cubesize": 32}
    base.update(changes)
    for key, value in base.items():
        line = next(ln for ln in text.splitlines() if ln.startswith(f"{key} = "))
        text = text.replace(line, f"{key} = {value}")
    if tpu:
        text += f"\n[TPU]\n{tpu}\n"
    path = root / "config.ini"
    path.write_text(text)
    return str(path)


def _jax_net():
    jm = JaxImplicitNet(d_in=3, hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0, radius_init=0.5)
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _save_weights(trainer, params, epoch=0):
    state = {"model": params_from_jax(params), "epoch": epoch}
    for name in (f"model_epoch{epoch}.ckpt", "best_model.ckpt"):
        save_checkpoint(f"{trainer.model_save_path}/{name}", state)


def _vertices_close(got, want):
    # as test_torch_reconstruct_e2e.py: within 1e-5 but where an edge's end
    # values nearly coincide (under 0.1% of vertices), there 1e-3
    diff = np.abs(np.asarray(got, np.float64) - want).max(axis=-1).reshape(-1)
    assert np.mean(diff <= 1e-5) > 0.999
    assert diff.max() <= 1e-3


def _record_metrics_inputs(monkeypatch):
    """Record (pred, true) of every audit's compute_grid_metrics call."""
    seen = []
    metrics_fn = post_process.compute_grid_metrics

    def record(pred, true, **kw):
        seen.append((pred.clone(), true.clone()))
        return metrics_fn(pred, true, **kw)

    monkeypatch.setattr(post_process, "compute_grid_metrics", record)
    return seen


def test_audit_shards_exact_distance_over_the_training_mesh(tmp_path, monkeypatch):
    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "sphere.stl"))
    cfg = Configuration(_config(tmp_path, ppo=True))
    _, params = _jax_net()
    _save_weights(Trainer(cfg, device="cpu"), params)
    # the audit's grid is too small for "auto" to pick the culled method,
    # the one a mesh shards (as in the JAX package): ask for it
    monkeypatch.setattr(post_process, "signed_distance",
                        lambda *a, **kw: sdf_exact.signed_distance(*a, method="culled", **kw))
    calls = {"dist": 0, "wind": 0}
    for name, key in (("dist_stream_sharded_plain", "dist"), ("wind_stream_sharded_plain", "wind")):
        fn = getattr(sdf_streams, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(sdf_streams, name, counted)
    seen = _record_metrics_inputs(monkeypatch)

    single = post_process.post_process(Trainer(cfg, device="cpu"))
    assert calls == {"dist": 0, "wind": 0}
    sharded = post_process.post_process(Trainer(cfg, device="cpu", mesh=("cpu",) * 2))
    assert calls == {"dist": 1, "wind": 1}  # the sharded walk carried the exact distances
    (pred1, true1), (pred2, true2) = seen
    assert torch.equal(true1, true2) and torch.equal(pred1, pred2)
    for key in ("nmse_0.01", "nmse_0.00025", "sign_accuracy", "n_mismatch_1", "n_mismatch_2"):
        assert single[key] == sharded[key]


@pytest.mark.parametrize("cubesize", [32, 64])
def test_cpu_entry_point_evaluates_as_the_jax_cpu_path(tmp_path, monkeypatch, cubesize):
    """No ``--compute-dtype``: the default (bfloat16) is the kernels' type on
    the card; on the CPU the field is the module's own f32 forward on the
    dense grid. 64 stands in for the sparse route (>= 256 on a card)."""
    monkeypatch.setattr(reconstruct, "SPARSE_MIN_CUBESIZE", 64)
    save_mesh(make_icosphere(2, 0.5), str(tmp_path / "sphere.stl"))
    jm, params = _jax_net()
    trainer = Trainer(Configuration(_config(tmp_path, cubesize=cubesize)), device="cpu")
    _save_weights(trainer, params)

    assert main([_config(tmp_path, cubesize=cubesize, ppo=True, reconstruct=True), "--device", "cpu"]) == 0
    trainer.load_model(best=False)
    ours = reconstruct.reconstruct_mesh(trainer.model, cubesize)  # compute_dtype left at bfloat16
    ref = jax_reconstruct(jm.apply, params, cubesize, model=jm, use_pallas=False)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    _vertices_close(ours.vertices, ref.vertices)
    stl = pathlib.Path(trainer.postprocess_save_path) / "reconstructed_epoch0.stl"
    assert stl.exists()

    seen = _record_metrics_inputs(monkeypatch)
    assert main([_config(tmp_path, cubesize=cubesize, ppo=True), "--device", "cpu"]) == 0
    (pred, _), = seen
    want = jax_evaluate_points(jm.apply, params, jax_grid_coords(cubesize))
    np.testing.assert_allclose(pred.numpy(), want, rtol=1e-5, atol=1e-5)


class _Recorder(torch.nn.Module):
    """A one-layer field whose loss records the float32 matmul precision
    the step runs under."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 1)
        self.lipschitz = False
        self.seen = []

    def forward(self, x):
        return self.lin(x)[:, 0]

    def loss(self, apply, x, y, epoch, generator=None, aux=None):
        self.seen.append(torch.get_float32_matmul_precision())
        return ((apply(x) - y) ** 2).mean()


@pytest.mark.parametrize("name,setting", [
    ("float32", "highest"), ("highest", "highest"), ("tensorfloat32", "high"), ("high", "high"),
    ("bfloat16_mxu", "medium"), ("default", None),
])
def test_train_matmul_precision_takes_the_jax_names(name, setting):
    model = _Recorder()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    before = torch.get_float32_matmul_precision()
    step = make_train_step(model, model.loss, opt, name)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32))
    loss = step(x, torch.zeros(16), 0)
    assert torch.isfinite(loss)
    assert model.seen == [before if setting is None else setting]
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="train_matmul_precision"):
        make_train_step(model, model.loss, opt, "fastest")


def test_debug_nans_turns_on_anomaly_detection(tmp_path):
    was = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(False)
        Trainer(Configuration(_config(tmp_path)), device="cpu")
        assert not torch.is_anomaly_enabled()
        trainer = Trainer(Configuration(_config(tmp_path, tpu="debug_nans = True")), device="cpu")
        assert trainer.config.debug_nans and torch.is_anomaly_enabled()
        opt = torch.optim.Adam(trainer.model.parameters(), lr=1e-3)

        def nan_backward(apply, x, y, epoch, generator=None, aux=None):
            return torch.sqrt((apply(x) * 0.0).sum())  # d sqrt at 0 is inf, times 0: NaN

        step = make_train_step(trainer.model, nan_backward, opt)
        with pytest.raises(RuntimeError, match="nan"):
            step(torch.rand(8, 3), torch.zeros(8), 0)
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_build_hands_nvcc_report_to_the_caller(tmp_path, monkeypatch):
    """``reports`` receives nvcc's output of a build that ran; a source built
    already runs nothing and adds nothing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("int k() { return 1; }\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
                    'echo "ptxas info    : Used 168 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    reports = {}
    assert kernels.build("k", reports=reports) > 0.0
    assert reports == {"k": "ptxas info    : Used 168 registers\n"}
    assert kernels.library_path("k").exists()
    again = {}
    assert kernels.build("k", reports=again) == 0.0 and again == {}


def test_serialised_wgmma_names_the_kernels():
    note = ("ptxas info    : (C{}) Potential Performance Loss: wgmma.mma_async instructions are serialized due "
            "to {} in the function '{}'\n")
    report = (note.format(7514, "non wgmma instructions reading accumulator registers of  a wgmma between start "
                          "and end of the pipeline stage", "_Z1bv")
              + "ptxas info    : Used 168 registers, used 16 barriers\n"
              + note.format(7511, "insufficient register resources for the wgmma pipeline", "_Z1av")
              + note.format(7514, "non wgmma instructions reading accumulator registers", "_Z1bv"))
    assert kernels.serialised_wgmma(report) == ["_Z1av", "_Z1bv"]
    assert kernels.serialised_wgmma("ptxas info    : Used 168 registers\n") == []


def test_build_cache_key_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k() { return A; }\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#define A B\n')
    (csrc / "b.cuh").write_text("#pragma once\n#define B 1\n")
    (csrc / "other.cuh").write_text("#define C 2\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    assert [p.name for p in kernels._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = kernels.library_path("k")
    assert kernels.library_path("k") == first
    (csrc / "other.cuh").write_text("#define C 3\n")  # not included: same library
    assert kernels.library_path("k") == first
    (csrc / "b.cuh").write_text("#pragma once\n#define B 2\n")  # included through a.cuh
    second = kernels.library_path("k")
    assert second != first
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A (B + 1)\n')
    assert kernels.library_path("k") not in (first, second)
