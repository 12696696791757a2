"""The port's export package against the JAX package's, on the CPU.

Weights are made by the JAX ImplicitNet from a seed and carried into the
port's module with ``convert.params_from_jax``. Tolerances:
  * the .sdfw, int8 .sdfw, .onnx and quantized .onnx files are byte-equal
    (the same float32 weights through the same writers); for the Lipschitz
    variant the baked row scaling differs: softplus(c) rounds the same in
    both, but torch and XLA sum each row's |w| in different orders (2 ulp
    apart on these rows, the scale 3), so there the tensors are held within
    8 ulp of float32 (6 read here) and the files compared by bytes only
    where they agree;
  * onnx_eval and the TorchScript files evaluate equal (the same numpy and
    torch CPU arithmetic on equal weights);
  * the parity fixtures: input.csv byte-equal (the same draws), output.csv
    and gradient.csv within rtol 1e-5 / atol 1e-6 (two float32 forwards and
    backward passes that sum in different orders);
  * the native consumers on the port's files: the JAX tests' limits, values
    rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-4
    (tests/test_export_native.py).
"""

import io
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.export import conversion as jconv
from sdf_representation_tpu.export import native_format as jnf
from sdf_representation_tpu.export import onnx_eval as jeval
from sdf_representation_tpu.export import onnx_export as jonnx
from sdf_representation_tpu.export import quantize as jq
from sdf_representation_tpu.export import torch_import as jti
from sdf_representation_tpu.export import torchscript_export as jts
from sdf_representation_tpu.models import ImplicitNet as JaxNet
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.export import (conversion, native_format, onnx_eval,
                                                 onnx_export, quantize, torch_import,
                                                 torchscript_export)
from sdf_representation_tpu_torch.export.native_runtime import NativeSDF
from sdf_representation_tpu_torch.export.onnx_lint import lint_onnx
from sdf_representation_tpu_torch.models import ImplicitNet

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# softplus 4x64 with a skip at layer 2 (configs/circle_2d.ini's shape) and a
# ReLU/tanh net with no skip
ARCHS = {
    "softplus": dict(hidden_dims=(64,) * 4, skip_in=(2,), beta=100.0),
    "relu": dict(hidden_dims=(32,) * 3, skip_in=(), beta=0.0, geometric_init=False),
}


def _pair(arch, seed=0, lipschitz=False):
    """(JAX model, its params, the port's module with the same weights)."""
    kw = ARCHS[arch]
    jm = JaxNet(d_in=3, lipschitz=lipschitz, **kw)
    params = jm.init(jax.random.PRNGKey(seed))
    if lipschitz:  # non-trivial scaling on every layer
        params["layers"] = [{**layer, "c": jnp.asarray(0.8)} for layer in params["layers"]]
    tm = ImplicitNet(d_in=3, lipschitz=lipschitz, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _write_all(tmp_path, jm, params, tm):
    """{file: (JAX bytes, port bytes)} of the four weight files."""
    out = {}
    for name, jax_write, port_write in (
        ("model.sdfw", lambda p: jnf.save_sdfw(p, jm, params), lambda p: native_format.save_sdfw(p, tm)),
        ("model_int8.sdfw", lambda p: jq.save_sdfw_quantized(p, jm, params),
         lambda p: quantize.save_sdfw_quantized(p, tm)),
        ("model.onnx", lambda p: jonnx.save_as_onnx(p, jm, params),
         lambda p: onnx_export.save_as_onnx(p, tm)),
        ("model_quant.onnx", lambda p: jonnx.save_as_onnx_quantized(p, jm, params),
         lambda p: onnx_export.save_as_onnx_quantized(p, tm)),
    ):
        jax_write(str(tmp_path / f"jax_{name}"))
        port_write(str(tmp_path / name))
        out[name] = ((tmp_path / f"jax_{name}").read_bytes(), (tmp_path / name).read_bytes())
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weight_files_byte_equal_jax(tmp_path, arch):
    jm, params, tm = _pair(arch)
    for name, (theirs, ours) in _write_all(tmp_path, jm, params, tm).items():
        assert ours == theirs, name
    arch_d, sd = native_format.load_sdfw(str(tmp_path / "model.sdfw"))
    assert arch_d == {"d_in": 3, "hidden_dims": list(ARCHS[arch]["hidden_dims"]),
                      "skip_in": list(ARCHS[arch]["skip_in"]), "beta": ARCHS[arch]["beta"]}
    for key, value in tm.state_dict().items():
        assert torch.equal(sd[key], value), key
    back = ImplicitNet(**arch_d, device="cpu")
    back.load_state_dict(sd)
    # the int8 file dequantizes to the JAX package's dequantized weights
    _, sd8 = quantize.load_sdfw_any(str(tmp_path / "model_int8.sdfw"))
    _, jax8 = jq.load_sdfw_any(str(tmp_path / "jax_model_int8.sdfw"))
    assert sd8.keys() == params_from_jax(jax8).keys()
    for key, value in params_from_jax(jax8).items():
        assert torch.equal(sd8[key], value), key
    for name in ("model.onnx", "model_quant.onnx"):
        assert lint_onnx(str(tmp_path / name)) == [], name
    with pytest.raises(ValueError, match="version"):
        native_format.load_sdfw(str(tmp_path / "model_int8.sdfw"))


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 steps between same-signed entries."""
    assert np.all(np.sign(a) == np.sign(b))
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def test_lipschitz_files_match_jax(tmp_path):
    """The Lipschitz row scaling is baked in by both packages: the scaled
    weights within 8 ulp (the row sums' summation order, see the module's
    docstring), the biases equal."""
    jm, params, tm = _pair("softplus", seed=3, lipschitz=True)
    files = _write_all(tmp_path, jm, params, tm)
    ours = native_format.load_sdfw(str(tmp_path / "model.sdfw"))[1]
    theirs = params_from_jax(jnf.load_sdfw(str(tmp_path / "jax_model.sdfw"))[1])
    ulps = {key: _ulp(ours[key].numpy(), value.numpy()) for key, value in theirs.items()}
    assert max(ulps.values()) <= 8, ulps
    assert all(ulps[f"lin{i}.bias"] == 0 for i in range(5)), ulps
    if files["model.sdfw"][0] == files["model.sdfw"][1]:
        assert all(a == b for a, b in files.values())
    # the baked weights are what the port's own forward uses
    pts = np.random.default_rng(2).uniform(-1, 1, (64, 3)).astype(np.float32)
    plain = ImplicitNet(d_in=3, **ARCHS["softplus"], device="cpu")
    plain.load_state_dict(ours)
    with torch.no_grad():
        np.testing.assert_array_equal(plain(torch.from_numpy(pts)).numpy(),
                                      tm(torch.from_numpy(pts)).numpy())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_evaluators_match_jax(tmp_path, arch):
    jm, params, tm = _pair(arch, seed=1)
    pts = np.random.default_rng(7).uniform(-1, 1, (200, 3)).astype(np.float32)
    onnx_export.save_as_onnx(str(tmp_path / "m.onnx"), tm)
    jonnx.save_as_onnx(str(tmp_path / "j.onnx"), jm, params)
    ours = onnx_eval.run_onnx(str(tmp_path / "m.onnx"), {"points": pts})["sdf"]
    theirs = jeval.run_onnx(str(tmp_path / "j.onnx"), {"points": pts})["sdf"]
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours[:, 0], tm(torch.from_numpy(pts)).detach().numpy(),
                               rtol=1e-5, atol=1e-6)

    pt, _, _ = torchscript_export.save_as_torchscript(str(tmp_path / "ours"), tm, n_fixture=8)
    jpt, _, _ = jts.save_as_torchscript(str(tmp_path / "jax"), jm, params, n_fixture=8)
    np.testing.assert_array_equal(torchscript_export.eval_torchscript(pt, pts),
                                  jts.eval_torchscript(jpt, pts))
    vals, grads = torchscript_export.eval_torchscript(pt, pts, gradients=True)
    jvals, jgrads = jts.eval_torchscript(jpt, pts, gradients=True)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(grads, jgrads)
    back = torchscript_export.import_torchscript(pt, device="cpu")
    assert (back.d_in, back.hidden_dims, back.skip_in, back.beta) == (
        tm.d_in, tm.hidden_dims, tm.skip_in, tm.beta)
    for key, value in tm.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    # and from the JAX package's .pt as well
    back = torchscript_export.import_torchscript(jpt, device="cpu")
    for key, value in tm.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def _reference_state_dict(layout, seed=0):
    """A reference-style state_dict (lin{i} or layers.{i}, (out, in))."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(32, 3), (29, 32), (32, 32), (1, 32)]  # skip into layer 2
    sd = {}
    for i, (o, k) in enumerate(shapes):
        name = {"lin": f"lin{i}", "module.lin": f"module.lin{i}", "layers": f"layers.{i}"}[layout]
        sd[f"{name}.weight"] = torch.randn(o, k, generator=g)
        sd[f"{name}.bias"] = torch.randn(o, generator=g)
    return sd


@pytest.mark.parametrize("layout", ["module.lin", "layers"])
def test_import_state_dict_matches_jax(layout):
    sd = _reference_state_dict(layout)
    ours = torch_import.import_torch_state_dict(sd)
    theirs = params_from_jax(jti.import_torch_state_dict(sd))
    assert ours.keys() == theirs.keys()
    for key in theirs:
        assert torch.equal(ours[key], theirs[key]), key
    assert torch_import.infer_architecture(ours) == jti.infer_architecture(
        jti.import_torch_state_dict(sd)) == ((32, 32, 32), (2,))
    with pytest.raises(ValueError, match="incomplete"):
        torch_import.import_torch_state_dict({k: v for k, v in sd.items() if "2.bias" not in k})
    with pytest.raises(ValueError, match="not an ImplicitNet"):
        torch_import.import_torch_state_dict({"fc.weight": torch.zeros(2, 2)})


class _Payload:
    """An object whose unpickling would run code."""

    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_load_reference_checkpoint(tmp_path):
    """Both reference checkpoint forms (executor.py:237-257) load with
    nothing but state-dict globals: torch.save's zip (with a numpy scalar
    loss) and best_model.pkl's plain pickle.dump; a file that needs any
    other global is refused."""
    sd = _reference_state_dict("lin", seed=4)
    blob = {"epoch": 12, "model_state_dict": sd, "loss": np.float64(0.25), "val_loss": 0.5,
            "optimizer_state_dict": torch.optim.Adam(
                [torch.nn.Parameter(torch.zeros(3))]).state_dict()}
    zipped, plain = tmp_path / "model_epoch12.pkl", tmp_path / "best_model.pkl"
    torch.save(blob, zipped)
    with open(plain, "wb") as f:
        pickle.dump(blob, f)
    for path in (zipped, plain):
        ours, epoch = torch_import.load_reference_checkpoint(str(path))
        theirs, jepoch = jti.load_reference_checkpoint(str(path))
        assert epoch == jepoch == 12
        for key, value in params_from_jax(theirs).items():
            assert torch.equal(ours[key], value), key
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"epoch": 1, "model_state_dict": sd, "x": _Payload()}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|nt.system"):
        torch_import.load_reference_checkpoint(str(bad))
    buf = io.BytesIO()
    torch.save({"epoch": 1, "model_state_dict": sd, "x": _Payload()}, buf)
    (tmp_path / "bad_zip.pkl").write_bytes(buf.getvalue())
    with pytest.raises(pickle.UnpicklingError):
        torch_import.load_reference_checkpoint(str(tmp_path / "bad_zip.pkl"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_parity_fixtures_match_jax(tmp_path, arch):
    jm, params, tm = _pair(arch, seed=2)
    ours = conversion.write_parity_fixtures(str(tmp_path / "ours"), tm, n_points=96)
    theirs = jconv.write_parity_fixtures(str(tmp_path / "jax"), jm, params, n_points=96)
    assert open(ours["input"], "rb").read() == open(theirs["input"], "rb").read()
    for key in ("output", "gradient"):
        np.testing.assert_allclose(np.loadtxt(ours[key], delimiter=","),
                                   np.loadtxt(theirs[key], delimiter=","), rtol=1e-5, atol=1e-6)
    assert torch.get_float32_matmul_precision() == "highest"


def _run(*cmd):
    subprocess.run([str(c) for c in cmd], check=True, capture_output=True)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_native_consumers_on_port_files(tmp_path, arch, native_build):
    """parity_main on model.sdfw, NativeSDF on .sdfw / int8 .sdfw / .onnx,
    and deeptrace on model.onnx, against the port's fixtures and forward."""
    _, _, tm = _pair(arch, seed=5)
    out = tmp_path / "out"
    paths = conversion.save_for_native(str(out), tm)
    quantize.save_sdfw_quantized(str(out / "model_int8.sdfw"), tm)
    fx = conversion.write_parity_fixtures(str(out), tm, n_points=128)
    _run(os.path.join(native_build, "parity_main"), paths["sdfw"], fx["input"],
         out / "o.csv", out / "g.csv")
    ref_v = np.loadtxt(fx["output"], delimiter=",")
    ref_g = np.loadtxt(fx["gradient"], delimiter=",")
    np.testing.assert_allclose(np.loadtxt(out / "o.csv", delimiter=","), ref_v, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(out / "g.csv", delimiter=","), ref_g, rtol=1e-3, atol=1e-4)

    pts = np.loadtxt(fx["input"], delimiter=",").astype(np.float32)
    lib = os.path.join(native_build, "libsdfnet_c.so")
    for name in ("model.sdfw", "model.onnx"):
        with NativeSDF(str(out / name), lib_path=lib) as net:
            vals, grads = net.evaluate(pts, gradients=True)
        np.testing.assert_allclose(vals, ref_v, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(grads, ref_g, rtol=1e-3, atol=1e-4)
    # int8 weights: the native runtime equals the port's dequantized forward
    arch_d, sd8 = quantize.load_sdfw_any(str(out / "model_int8.sdfw"))
    deq = ImplicitNet(**arch_d, device="cpu")
    deq.load_state_dict(sd8)
    with NativeSDF(str(out / "model_int8.sdfw"), lib_path=lib) as net:
        np.testing.assert_allclose(net(pts), deq(torch.from_numpy(pts)).detach().numpy(),
                                   rtol=1e-4, atol=1e-5)

    cfg = tmp_path / "config.txt"
    cfg.write_text(f"refine_lvl_uni = 2\nrefine_lvl_bd = 4\ncubeDomainMin = [-1.0, -1.0, -1.0]\n"
                   f"cubeDomainMax = [1.0, 1.0, 1.0]\nModelFileName = \"{out}/model.onnx\"\n"
                   f"useDeepLearning = true\n")
    res = subprocess.run([os.path.join(native_build, "deeptrace"), str(cfg), str(out)],
                         check=True, capture_output=True, text=True)
    assert "leaf cells" in res.stdout
    leaf = np.loadtxt(out / "points.csv", delimiter=",")
    with torch.no_grad():
        want = tm(torch.from_numpy(leaf[:, :3].astype(np.float32))).numpy()
    np.testing.assert_allclose(leaf[:, 3], want, rtol=1e-4, atol=1e-5)


def _checkpointed_run(tmp_path):
    """A config and a best_model.ckpt of the port's trainer (2 epochs on
    the CPU)."""
    from sdf_representation_tpu_torch.configgen import Configuration
    from sdf_representation_tpu_torch.data.dataset import SDFDataset
    from sdf_representation_tpu_torch.training import Trainer

    text = (open(os.path.join(REPO, "configs", "circle_2d.ini")).read()
            .replace("directory = ./runs/", f"directory = {tmp_path}/runs/")
            .replace("epochs = 500", "epochs = 2").replace("min_epochs = 50", "min_epochs = 2")
            .replace("batch_size = 4096", "batch_size = 256"))
    ini = tmp_path / "c.ini"
    ini.write_text(text)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1200, 3)).astype(np.float32)
    s = (np.linalg.norm(x, axis=1) - 0.5).astype(np.float32)
    y = np.column_stack([s, x / np.linalg.norm(x, axis=1, keepdims=True)]).astype(np.float32)
    trainer = Trainer(Configuration(str(ini)), device="cpu")
    trainer.train(dataset=SDFDataset(x[:1000], y[:1000], x[1000:], y[1000:]))
    return ini, trainer


def test_export_cli(tmp_path):
    """python -m sdf_representation_tpu_torch.export writes every file from
    the port trainer's best checkpoint with --device cpu; with no device
    named and no card it raises."""
    from sdf_representation_tpu_torch.export.__main__ import main

    ini, trainer = _checkpointed_run(tmp_path)
    out = tmp_path / "exported"
    r = subprocess.run([sys.executable, "-m", "sdf_representation_tpu_torch.export", str(ini),
                        str(out), "--quantize", "--torchscript", "--fixtures", "16",
                        "--device", "cpu"], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    for f in ("model.sdfw", "model.onnx", "model_quant.onnx", "model_int8.sdfw",
              "implicit_model.pt", "input.csv", "output.csv", "gradient.csv"):
        assert (out / f).exists(), f
    _, epoch = trainer.load_model(best=True)
    assert f"loaded checkpoint from epoch {epoch}" in r.stdout
    _, sd = native_format.load_sdfw(str(out / "model.sdfw"))
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(sd[key], value), key
    pts = np.loadtxt(out / "input.csv", delimiter=",").astype(np.float32)
    assert pts.shape == (16, 3)
    with torch.no_grad():
        want = trainer.model(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(np.loadtxt(out / "output.csv", delimiter=","), want,
                               rtol=1e-6, atol=1e-7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([str(ini), str(tmp_path / "nowhere")])
