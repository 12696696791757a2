"""Instant-NGP's hash-grid SDF on the port, on the CPU: the INI's encoding
keys, the port's HashMLP against the benchmark's plain reference
(``portbench/reference/hashmlp.py``), the hash encoding's route rule
(``ops/hash_grid.py``), the reference's counts of work, and the
``hashmlp-16x2e19.train-sup-hash`` cell cut to CPU size, and the readers of
its two per-layer metrics on hand-built traces.

The comparison size has dense and hashed levels (4 levels of 2^9 rows,
resolutions 4 to 32: (4+1)^3 = 125 <= 512 is indexed directly, the others
hash), tables redrawn uniform in +-0.1 so that the features carry signal.
Limits: the forward within 1e-6 and every gradient within 1e-5 of its
tensor's largest entry, float32 summation order (the port sums the 8
corners of one gather, the reference corner by corner).
"""

import hashlib
import math
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import runner, spec, tracing
from portbench.harness.tracing import Event, Trace
from portbench.reference import train as ref_train
from portbench.tests.conftest import tiny
from sdf_representation_tpu_torch.configgen.config_reader import Configuration
from sdf_representation_tpu_torch.losses.losses import WeightedSmoothL2Loss
from sdf_representation_tpu_torch.models import HashMLP
from sdf_representation_tpu_torch.ops import hash_grid
from sdf_representation_tpu_torch.training.trainer import make_train_step

REPO = Path(__file__).resolve().parent.parent
CELL = "hashmlp-16x2e19.train-sup-hash"
FAMILY = spec.family_module({"reference": "hashmlp"})
SMALL = {"input_dim": 3, "hidden_dim": 16, "num_hidden_layers": 3, "n_levels": 4, "n_features": 2,
         "log2_table_size": 9, "base_resolution": 4, "max_resolution": 32}

# sha256 of every shipped INI's model (state_dict, names and bytes), weights
# drawn from torch.Generator().manual_seed(7), as the reader built them
# before it read the encoding's keys
SHIPPED = {
    "configs/circle_2d.ini": ("ImplicitNet", "55ceafde1c5ed78f"),
    "configs/mesh_sdf.ini": ("ImplicitNet", "4359380e3134ddd7"),
    "configs/mesh_sdf_hash.ini": ("HashMLP", "5020985ba270f9d6"),
    "configs/pointcloud_igr.ini": ("ImplicitNet", "009d3c4d6471a186"),
    "tests/test_config.ini": ("ImplicitNet", "507a83e8c39ed062"),
}


def _digest(model) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("path", sorted(SHIPPED))
def test_every_shipped_ini_builds_the_model_it_built_before(path):
    cfg = Configuration(str(REPO / path))
    model = cfg.make_model(generator=torch.Generator().manual_seed(7))
    assert (type(model).__name__, _digest(model)) == SHIPPED[path]
    assert cfg.hash_encoding() == {}


def _hash_ini(tmp_path, **model_keys) -> str:
    text = (REPO / "configs" / "mesh_sdf_hash.ini").read_text()
    extra = "".join(f"{k} = {v}\n" for k, v in model_keys.items())
    path = tmp_path / "hash.ini"
    path.write_text(text.replace("[Loss]", extra + "\n[Loss]"))
    return str(path)


def test_the_encoding_keys_build_instant_ngps_published_sizes(tmp_path):
    config = spec.resolve(CELL).config["ini"]["Model"]
    keys = {k: config[k] for k in ("n_levels", "n_features", "log2_table_size", "base_resolution",
                                   "max_resolution", "include_xyz")}
    assert keys == {"n_levels": 16, "n_features": 2, "log2_table_size": 19, "base_resolution": 16,
                    "max_resolution": 2048, "include_xyz": "False"}
    cfg = Configuration(_hash_ini(tmp_path, **keys))
    model = cfg.make_model()
    assert isinstance(model, HashMLP) and not model.include_xyz
    assert tuple(model.tables.shape) == (16, 1 << 19, 2)
    assert model.resolutions[0] == 16 and model.resolutions[-1] == 2048
    assert model.growth == pytest.approx(128 ** (1 / 15))
    assert [model.is_dense(lv) for lv in range(16)] == [True] * 5 + [False] * 11
    assert [(layer.w.shape[0], layer.w.shape[1]) for layer in model.mlp] == [(32, 64), (64, 64), (64, 1)]
    assert sum(p.numel() for p in model.parameters()) == 16 * (1 << 19) * 2 + 2112 + 4160 + 65
    # the reference reads the same sizes from the same section
    net = FAMILY.net(config)
    assert FAMILY.resolutions(net) == list(model.resolutions)
    assert FAMILY._dims(net) == [32, 64, 64, 1]


def test_an_absent_key_keeps_the_models_default(tmp_path):
    cfg = Configuration(_hash_ini(tmp_path, n_levels=4, include_xyz="True"))
    assert cfg.hash_encoding() == {"n_levels": 4, "include_xyz": True}
    model = cfg.make_model()
    default = HashMLP()
    assert (model.n_levels, model.table_size, model.base_resolution, model.max_resolution) == (
        4, default.table_size, default.base_resolution, default.max_resolution)


def _pair(seed=5):
    """The port's model and the reference's parameters, the same weights:
    the reference's initialisation, the tables redrawn in +-0.1."""
    net = FAMILY.net(SMALL)
    params = FAMILY.init_params(net, seed, "cpu")
    params[0] = (torch.rand(params[0].shape, generator=torch.Generator().manual_seed(seed + 1)) * 2
                 - 1) * 0.1
    model = HashMLP(**{k: SMALL[k] for k in ("n_levels", "n_features", "log2_table_size",
                                              "base_resolution", "max_resolution")},
                    hidden_dim=16, num_layers=3, include_xyz=True)
    with torch.no_grad():
        for p, q in zip(model.parameters(), params):
            p.copy_(q)
    return net, params, model


def _batch(n=512, seed=6):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=gen) * 2.1 - 1.05
    x[:4] = torch.tensor([[-1.0, -1, -1], [1, 1, 1], [0, 0, 0], [0.5, -0.25, 1]])
    r = x.norm(dim=1, keepdim=True)
    return x, torch.cat([r - 0.5, x / r], dim=1)


def test_the_reference_draws_the_ports_initial_parameters():
    net = FAMILY.net(SMALL)
    port = HashMLP(n_levels=4, log2_table_size=9, base_resolution=4, max_resolution=32, hidden_dim=16,
                   num_layers=3, generator=torch.Generator().manual_seed(11))
    mine = FAMILY.init_params(net, 11, "cpu")
    assert [tuple(p.shape) for p in port.parameters()] == [tuple(p.shape) for p in mine]
    assert all(torch.equal(a, b) for a, b in zip(port.parameters(), mine))


def test_the_port_matches_the_reference_forward_and_gradients():
    net, params, model = _pair()
    x, y = _batch()
    target = y[:, 0]
    ref_params = [p.clone().requires_grad_(True) for p in params]
    want = FAMILY.forward(ref_params, x, net)
    got = model(x)
    assert (got - want).abs().max().item() <= 1e-6
    torch.mean((want - target) ** 2).backward()
    torch.mean((got - target) ** 2).backward()
    assert torch.count_nonzero(model.tables.grad) > 1000
    for p, q in zip(model.parameters(), ref_params):
        scale = q.grad.abs().max().item()
        assert (p.grad - q.grad).abs().max().item() <= 1e-5 * scale


def test_one_supervised_step_matches_the_reference():
    """One step of the port's ``make_train_step`` (SGD, so the move is the
    gradient) against the reference's loss and gradient on the same batch."""
    net, params, model = _pair(seed=8)
    x, y = _batch(seed=9)
    lr = 1e-2
    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(model, WeightedSmoothL2Loss(), torch.optim.SGD(model.parameters(), lr=lr))
    loss = step(x, y, 0)
    ref_params = [p.clone().requires_grad_(True) for p in params]
    ref_loss = ref_train.loss("WeightedSmoothL2Loss", FAMILY.forward, ref_params, {"x": x, "y": y}, net,
                              {"weight_factor": 0.5, "delta": 0.1}, "f32")
    grads = torch.autograd.grad(ref_loss, ref_params)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for p0, p, g in zip(before, model.parameters(), grads):
        moved, ref_moved = (p0 - p.detach()) / lr, (p0 - (p0 - lr * g)) / lr  # both rounded alike
        assert (moved - ref_moved).abs().max().item() <= 1e-5 * ref_moved.abs().max().item()


class _Recorded:
    """Stands in for the kernel pair on the CPU: the plain encoding, its
    calls counted."""

    calls = 0

    @classmethod
    def apply(cls, x, tables, resolutions):
        cls.calls += 1
        return hash_grid.encode_plain(x, tables, resolutions)


def _routes(fn):
    before = dict(hash_grid.ROUTE)
    fn()
    return {k: hash_grid.ROUTE[k] - before[k] for k in before}


def test_the_cpu_takes_the_plain_route():
    _, _, model = _pair()
    x, _ = _batch()
    assert not hash_grid.kernel_serves(x, model.tables)
    assert _routes(lambda: model(x)) == {"kernel": 0, "plain": 1}


@pytest.mark.parametrize("case", ["float32", "no_grad", "x_needs_grad", "bfloat16_step", "jvp",
                                  "float32_step"])
def test_the_route_rule(monkeypatch, case):
    """With the device test answering "a card", the kernels take float32
    tables and points that need no gradient, and nothing else."""
    monkeypatch.setattr(hash_grid, "_on_card", lambda t: True)
    monkeypatch.setattr(hash_grid, "_Encode", _Recorded)
    _, _, model = _pair()
    x, y = _batch(n=64)
    want = {"float32": "kernel", "no_grad": "kernel", "x_needs_grad": "plain",
            "bfloat16_step": "plain", "jvp": "plain", "float32_step": "kernel"}[case]
    if case == "float32":
        run = lambda: model(x)  # noqa: E731
    elif case == "no_grad":
        def run():
            with torch.no_grad():
                model(x)
    elif case == "x_needs_grad":
        run = lambda: model(x.clone().requires_grad_(True))  # noqa: E731
    elif case == "jvp":
        run = lambda: torch.func.jvp(model, (x,), (torch.ones_like(x),))  # noqa: E731
    else:
        precision = "bfloat16" if case == "bfloat16_step" else "float32"
        step = make_train_step(model, WeightedSmoothL2Loss(), torch.optim.SGD(model.parameters(), lr=1e-3),
                               precision)
        run = lambda: step(x, y, 0)  # noqa: E731
    routes = _routes(run)
    assert routes[want] >= 1 and routes["plain" if want == "kernel" else "kernel"] == 0, routes


@pytest.mark.parametrize("points,raises", [
    ("float32", False), ("float64", True), ("bfloat16", True), ("four_columns", True),
    ("one_dim", True)])
def test_the_kernel_route_takes_float32_points_or_raises(monkeypatch, points, raises):
    """Float32 tables on a card and points that need no gradient take the
    kernels whatever the points are: float32 (n, 3) points on the tables'
    card run, any other raises rather than take the plain route unseen."""
    monkeypatch.setattr(hash_grid, "_on_card", lambda t: True)
    monkeypatch.setattr(hash_grid, "_Encode", _Recorded)
    _, _, model = _pair()
    x, _ = _batch(n=64)
    x = {"float32": x, "float64": x.double(), "bfloat16": x.to(torch.bfloat16),
         "four_columns": torch.cat([x, x[:, :1]], dim=1), "one_dim": x[:, 0]}[points]
    before = _Recorded.calls
    if raises:
        with pytest.raises(ValueError, match="float32 \\(n, 3\\) points"):
            hash_grid.encode(x, model.tables, model.resolutions)
    else:
        hash_grid.encode(x, model.tables, model.resolutions)
    assert _Recorded.calls - before == (0 if raises else 1)


def test_work_gives_the_hand_counts():
    net = FAMILY.net(spec.resolve(CELL).config["ini"]["Model"])
    work = FAMILY.work(net, "WeightedSmoothL2Loss", 16384, 16384, "float32")
    mlp = 32 * 64 + 64 * 64 + 64  # MACs of the 32 -> 64 -> 64 -> 1 MLP
    interp = 8 * 16 * 2  # the 8 corners' weighted sums of 16 levels x 2 features
    assert work["flops_per_point"] == 2.0 * (3 * mlp + 2 * interp) == 38272.0
    # each level's corner rows read once: as many of the level's R rows as
    # the batch's 131,072 corners touch on average, drawn uniformly; 5 dense
    # levels of (res+1)^3 rows (resolutions 16, 22, 31, 42, 58), 11 hashed
    # ones of 2^19
    level = [17 ** 3, 23 ** 3, 32 ** 3, 43 ** 3, 59 ** 3] + [1 << 19] * 11
    rows = sum(r * (1 - (1 - 1 / r) ** 131072) for r in level) * 2 * 4
    points, feats = 16384 * 3 * 4, 16384 * 32 * 4
    fwd, bwd = work["hash_bound_s"]["hash_encode_fwd_kernel"], work["hash_bound_s"]["hash_encode_bwd_kernel"]
    assert fwd == pytest.approx((points + feats + rows) / 3.35e12, rel=1e-12)
    assert bwd == pytest.approx((feats + points + 2 * rows) / 3.35e12, rel=1e-12)
    # the 11 hashed levels touch ~116k rows each, the finest dense one ~97k of 205,379
    touched = [round(r * (1 - (1 - 1 / r) ** 131072)) for r in level]
    assert (touched[-1], touched[4]) == (115972, 96889)
    assert fwd + bwd == pytest.approx(12.02e-6, rel=1e-3)
    with pytest.raises(ValueError):
        FAMILY.work(net, "IGRLOSS", 16384, 16384, "float32")


def test_the_tiny_cell_runs_correct_on_the_cpu():
    cell = tiny(CELL)
    assert cell.config["reference"] == "hashmlp" and cell.limits
    before = dict(hash_grid.ROUTE)
    out = runner.run(cell, 2**31 + 29, 1.0, False, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0, out["checks"]
    assert math.isfinite(out["metrics"]["train_points_per_s"]["value"])
    assert hash_grid.ROUTE["plain"] > before["plain"] and hash_grid.ROUTE["kernel"] == before["kernel"]


def test_the_tiny_cells_control_fails():
    """The reference one precision down (tables, corner weights and the
    MLP's operands rounded to TF32) in the program's place fails the tiny
    limits that the program passes."""
    from portbench import calibrate
    from portbench.harness import compare

    cell = tiny(CELL)
    out = calibrate.readings(cell, 2**31 + 5, ["program", "control"], "cpu")
    assert compare.judge(out["program"], cell.limits)[0], out["program"]
    assert not compare.judge(out["control"], cell.limits)[0], out["control"]


FWD = "void (anonymous namespace)::hash_encode_fwd_kernel<2>(float const*, float const*, long long)"
BWD = "void (anonymous namespace)::hash_encode_bwd_kernel<2>(float const*, float const*, long long)"


def _hash_reading(bwd_calls=2, work=True):
    """A 0-1000 us ``training_loop`` of 2 steps: 3 forward calls of 10 us
    (2 steps, 1 validation batch), ``bwd_calls`` of 20 us, 100 us of other
    work; bounds 2 and 4 us a call."""
    events = [Event("training_loop", "user_annotation", 0, 1000, 1),
              Event("other_kernel", "kernel", 500, 600, 7)]
    events += [Event(FWD, "kernel", 100 * i, 100 * i + 10, 7) for i in range(3)]
    events += [Event(BWD, "kernel", 300 + 50 * i, 320 + 50 * i, 7) for i in range(bwd_calls)]
    bounds = {"hash_encode_fwd_kernel": 2e-6, "hash_encode_bwd_kernel": 4e-6}
    return runner.Reading(cell=None, setup_s=1.0, window={"steps": 2},
                          work={"span": "training_loop", **({"hash_bound_s": bounds} if work else {})},
                          trace=Trace(events))


def test_the_hash_readers_on_a_hand_built_trace():
    r = _hash_reading()
    assert spec.metric_reader("hash.encode_roofline")(r) == pytest.approx(100 * (3 * 2 + 2 * 4) / (30 + 40))
    assert spec.metric_reader("hash.busy_share")(r) == pytest.approx(100 * 70 / 170)
    # only the backward runs once a step: the validation batches run the forward
    per_step = [p for name in ("hash.encode_roofline", "hash.busy_share")
                for p in spec.metric_module(name).PER_STEP]
    assert set(per_step) == {"hash_encode_bwd_kernel"}
    assert tracing.lost(r.trace, 0, 1000, 2, per_step) == []
    assert tracing.lost(_hash_reading(bwd_calls=3).trace, 0, 1000, 2, per_step) != []


def test_the_hash_readers_read_nothing_where_the_program_has_no_kernels():
    """The parent's program in this cell, or another cell: no counts, no kernels."""
    assert spec.metric_reader("hash.encode_roofline")(_hash_reading(work=False)) is None
    bare = runner.Reading(cell=None, setup_s=1.0, window={"steps": 2}, work={"span": "training_loop"},
                          trace=Trace([Event("training_loop", "user_annotation", 0, 1000, 1),
                                       Event("other_kernel", "kernel", 500, 600, 7)]))
    for name in ("hash.encode_roofline", "hash.busy_share"):
        bare.work["hash_bound_s"] = {"hash_encode_fwd_kernel": 2e-6, "hash_encode_bwd_kernel": 4e-6}
        assert spec.metric_reader(name)(bare) is None
