"""The port's profiling helpers and plots on the CPU.

``trace`` writes one Chrome trace; ``force`` reaches the first tensor of a nested structure; ``debug_nans``
switches autograd's anomaly detection and is restored. The plots need
matplotlib (and PIL for the GIF): where it is missing they skip."""

import json

import numpy as np
import pytest
import torch

from sdf_representation_tpu_torch.geometry.mesh_io import Mesh, save_mesh
from sdf_representation_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert prof is not None
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_force_reaches_the_first_tensor(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    tree = {"a": [np.zeros(2), (3, torch.ones(2))], "b": torch.zeros(1)}
    assert profiling.force(tree) is None
    assert profiling.force([]) is None and profiling.force(np.ones(3)) is None
    assert synced == []  # CPU tensors: already computed


def test_force_synchronizes_a_card_tensor(monkeypatch):
    class Leaf(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 1)

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    leaf = torch.zeros(2).as_subclass(Leaf)
    profiling.force({"params": {"w": leaf, "b": torch.zeros(1)}})
    assert synced == [torch.device("cuda", 1)]


def test_debug_nans_switches_anomaly_detection():
    before = torch.is_anomaly_enabled()
    try:
        profiling.debug_nans()
        assert torch.is_anomaly_enabled()
        profiling.debug_nans(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
    assert torch.is_anomaly_enabled() == before


def test_plot_errors_writes_both_heatmaps(tmp_path):
    pytest.importorskip("matplotlib")
    from sdf_representation_tpu_torch.evaluations.visualize_errors import plot_errors
    from sdf_representation_tpu_torch.sampling.sampler import Frame

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (300, 3))
    Frame(("x", "y", "z", "error"), np.column_stack([pts, rng.uniform(0, 0.01, 300)])).to_csv(
        str(tmp_path / "error_points.csv"))
    Frame(("x", "y", "z", "similarity"), np.column_stack([pts, rng.uniform(-1, 1, 300)])).to_csv(
        str(tmp_path / "similarity_points.csv"), index=False)
    plot_errors(str(tmp_path))
    for name in ("error_heatmap.png", "similarity_heatmap.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name


def test_plot_stl_writes_a_gif(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    from sdf_representation_tpu_torch.evaluations.generate_gif import plot_stl

    # no symmetry under the half turn between the two frames (PIL merges equal frames)
    tet = Mesh(np.array([[0, 0, 0], [0.9, 0, 0], [0, 0.5, 0], [0, 0, 0.3]], float),
               np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]))
    save_mesh(tet, str(tmp_path / "mesh.stl"))
    gif = plot_stl(str(tmp_path / "mesh.stl"), str(tmp_path / "mesh.gif"), frames=2)
    assert gif == str(tmp_path / "mesh.gif")
    data = (tmp_path / "mesh.gif").read_bytes()
    assert data[:6] == b"GIF89a"
    from PIL import Image

    with Image.open(gif) as im:
        assert im.n_frames == 2
