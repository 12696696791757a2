"""The port imports neither JAX (nor flax/optax/pandas/sklearn/matplotlib/PIL) nor any
module of the JAX package — checked in a fresh interpreter, since this
pytest process has already loaded JAX."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "sdf_representation_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_load_no_jax_or_jax_package():
    mods = _port_modules()
    assert "sdf_representation_tpu_torch.ops.fused_mlp" in mods
    assert "sdf_representation_tpu_torch.ops.sdf_streams" in mods
    assert "sdf_representation_tpu_torch.evaluations.post_process" in mods
    assert "sdf_representation_tpu_torch.ops.fused_igr" in mods
    assert "sdf_representation_tpu_torch.ops.diffops" in mods
    assert "sdf_representation_tpu_torch.training.pcd_trainer" in mods
    assert "sdf_representation_tpu_torch.ops.sdf_culled" in mods
    assert "sdf_representation_tpu_torch.parallel.mesh" in mods
    assert "sdf_representation_tpu_torch.parallel.multihost" in mods
    assert "sdf_representation_tpu_torch.ops.sharded_eval" in mods
    assert "sdf_representation_tpu_torch.ops.marching_device" in mods
    assert "sdf_representation_tpu_torch.ops.giga_extract" in mods
    for name in ("native_format", "quantize", "onnx_export", "onnx_eval", "onnx_lint",
                 "protobuf_min", "torchscript_export", "torch_import", "native_runtime",
                 "conversion", "__main__"):
        assert f"sdf_representation_tpu_torch.export.{name}" in mods
    assert "sdf_representation_tpu_torch.export" in mods
    assert "sdf_representation_tpu_torch.evaluations.two_dim" in mods
    for name in ("hash_mlp", "ffn", "siren", "kan", "registry"):
        assert f"sdf_representation_tpu_torch.models.{name}" in mods
    assert "sdf_representation_tpu_torch.ops.hash_grid_eval" in mods
    for name in ("utils.profiling", "geometry.msh_io", "sampling.sampler2d", "sampling.distributed",
                 "sampling.__main__", "evaluations.normal_comparison", "evaluations.compare_octree_dl",
                 "evaluations.visualize_errors", "evaluations.generate_gif"):
        assert f"sdf_representation_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'sklearn', 'matplotlib', 'PIL') "
        "or k == 'sdf_representation_tpu' or k.startswith('sdf_representation_tpu.')]\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import\s+(jax|flax|optax|pandas|sklearn)\b"
                     r"|from\s+(jax|flax|optax|pandas|sklearn)\b"
                     r"|from\s+sdf_representation_tpu(\.|\s)|import\s+sdf_representation_tpu(\.|\s|$))",
                     re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path}: {hits}"
