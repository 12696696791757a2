"""The port's slab-streamed extractor (ops/giga_extract.py) against the JAX
package's on the CPU: the same slab plan; on a dense vol_fn the same merged
mesh as the JAX extractor and as one-shot device marching; with the default
evaluator (the blocks kernel's plain version, f32) the same mesh as marching
the port's whole sparse volume, each slab volume within the sparse tests'
tolerance (tests/test_torch_sparse_grid.py) of the JAX ``_refine_slab``.
The JAX package's own cases (tests/test_giga_extract.py: nonzero level,
steep field, seam fuzz, validation, overflow retry, empty level set) hold
here too; the merged mesh does not depend on the slab size or the device
list."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.models import ImplicitNet as JaxImplicitNet
from sdf_representation_tpu.models.hash_mlp import HashMLP
from sdf_representation_tpu.ops import giga_extract as jge
from sdf_representation_tpu_torch.convert import params_from_jax
from sdf_representation_tpu_torch.models import HashMLP as TorchHashMLP
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import giga_extract as ge
from sdf_representation_tpu_torch.ops import marching_device as md
from sdf_representation_tpu_torch.ops import sparse_grid
from sdf_representation_tpu_torch.ops.fused_mlp import LAUNCHES, fused_grid_eval
from sdf_representation_tpu_torch.ops.hash_grid_eval import hash_grid_eval_x_slab
from tests.test_giga_extract import _assert_same_mesh
from tests.test_giga_extract import _canon as canon
from tests.test_sparse_grid import _steep_plane_params

torch.set_num_threads(2)
F32 = torch.float32


@functools.cache
def _pair():
    """The JAX test's 3x32 net, and the port's with the same weights."""
    jm = JaxImplicitNet(d_in=3, hidden_dims=(32,) * 3, skip_in=(), beta=100.0, radius_init=0.5)
    params = jm.init(jax.random.PRNGKey(0))
    tm = ImplicitNet(d_in=3, hidden_dims=(32,) * 3, skip_in=(), beta=100.0, radius_init=0.5)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


@functools.cache
def _dense(n):
    return fused_grid_eval(_pair()[2], n, compute_dtype=F32).numpy()


def _one_shot(vol, level=0.0, wire="exact"):
    s = 2.0 / (vol.shape[0] - 1)
    return md.marching_cubes_device(torch.as_tensor(vol), level, (s,) * 3, (-1.0,) * 3, wire=wire)


@pytest.mark.parametrize("n", [32, 40, 256, 1024])
def test_slab_plan_and_default_slab_equal_jax(n):
    for n_devices in (1, 3, 4):
        slab = ge.default_slab(n, n_devices=n_devices)
        assert slab == jge.default_slab(n, n_devices=n_devices)
        assert ge._slab_plan(n, slab) == jge._slab_plan(n, slab)
        assert (slab + 1) * n * n * 7 < 2 ** 31
    if n == 1024:
        assert ge.default_slab(1024) == 288 and len(ge._slab_plan(1024, 288)) == 4


@pytest.mark.parametrize("wire", ["exact", "packed"])
def test_dense_vol_fn_equals_one_shot_and_jax(wire):
    """slab = 16 puts two seams through the r = 0.5 surface."""
    n = 40
    vol = _dense(n)
    ref = _one_shot(vol, wire=wire)
    assert len(ref[1]) > 100
    stages = {}
    giga = ge.extract_mesh_giga(None, n, slab=16, wire=wire, stages=stages,
                                vol_fn=lambda x0, sx: torch.from_numpy(vol[x0:x0 + sx]))
    _assert_same_mesh(giga, ref)
    jax_giga = jge.extract_mesh_giga(None, None, n, slab=16, wire=wire,
                                     vol_fn=lambda x0, sx: jnp.asarray(vol[x0:x0 + sx]))
    np.testing.assert_array_equal(giga[1], jax_giga[1])
    np.testing.assert_array_equal(giga[0], jax_giga[0])
    assert list(stages) == ["evaluate", "march", "decode"]
    assert all(v >= 0 for v in stages.values()) and (wire == "packed" or stages["decode"] == 0)


def test_default_evaluator_equals_the_whole_sparse_volume(monkeypatch):
    """n = 32, slab = 16: one blocks-kernel launch per slab on its active
    blocks by global id; the mesh equals marching the whole sparse volume,
    and each slab volume agrees with the JAX ``_refine_slab``."""
    jm, params, tm = _pair()
    n, block, slab = 32, 8, 16
    slabs = []
    real = md.marching_tets_device

    def record(vol, level=0.0):
        slabs.append(vol.clone())
        return real(vol, level)

    monkeypatch.setattr(md, "marching_tets_device", record)
    LAUNCHES["sparse_blocks"] = 0
    giga = ge.extract_mesh_giga(tm, n, slab=slab, wire="exact", compute_dtype=F32,
                                on_violation="error")
    plan = ge._slab_plan(n, slab)
    assert LAUNCHES["sparse_blocks"] == 0  # CPU tensors: the plain version, no launch
    assert len(slabs) == len(plan) == 2
    vol = sparse_grid.sparse_grid_eval(tm, n, compute_dtype=F32, on_violation="error")
    ref = _one_shot(vol)
    assert len(ref[1]) > 50
    _assert_same_mesh(giga, ref)

    coarse, mask, viol = jge._coarse_field(jm, params, n, block, 1.5, 0.01, 0.0)
    assert int(viol) == 0
    for (x0, sx), got in zip(plan, slabs):
        want, _ = jge._refine_slab(jm, params, coarse, mask, jnp.int32(x0 // block), n, block,
                                   512, slab // block + 1, 2, jnp.float32, True, "default")
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:sx], rtol=2e-5, atol=2e-5)
    # the shared plane x = 16 holds the same bits in both slabs (seam-exact)
    np.testing.assert_array_equal(slabs[0][slab].numpy(), slabs[1][0].numpy())


def test_devices_round_robin_identical():
    tm = _pair()[2]
    one = ge.extract_mesh_giga(tm, 32, slab=8, wire="packed", compute_dtype=F32,
                               on_violation="error")
    three = ge.extract_mesh_giga(tm, 32, slab=8, wire="packed", compute_dtype=F32,
                                 on_violation="error", devices=("cpu",) * 3)
    assert len(one[1]) > 50
    np.testing.assert_array_equal(three[1], one[1])
    np.testing.assert_array_equal(three[0], one[0])


@pytest.mark.parametrize("devices", [None, ("cpu",) * 3])
def test_next_slab_is_queued_between_the_device_half_and_the_decode(monkeypatch, devices):
    """One device, listed once or three times: slab i + 1's evaluation is
    queued after slab i's wire reached the host and before the host decodes
    it, so the device evaluates while the host decodes and only one slab
    volume is held at a time."""
    events = []
    refine, wire, unpack = ge._refine_slab, md.packed_wire, md.unpack_wire
    monkeypatch.setattr(ge, "_refine_slab",
                        lambda *a: events.append(("evaluate", a[3])) or refine(*a))
    monkeypatch.setattr(md, "packed_wire", lambda *a: events.append(("wire",)) or wire(*a))
    monkeypatch.setattr(md, "unpack_wire", lambda *a: events.append(("decode",)) or unpack(*a))
    ge.extract_mesh_giga(_pair()[2], 32, slab=8, wire="packed", compute_dtype=F32,
                         on_violation="error", devices=devices)
    slabs = len(ge._slab_plan(32, 8))
    want = [("evaluate", 0)]
    for i in range(slabs):
        want += [("wire",)] + [("evaluate", i + 1)] * (i + 1 < slabs) + [("decode",)]
    assert slabs == 4 and events == want


def test_nonzero_level_selects_the_right_shell():
    n, level = 32, 0.3
    ref = _one_shot(_dense(n), level)
    assert len(ref[1]) > 50
    giga = ge.extract_mesh_giga(_pair()[2], n, slab=16, level=level, wire="exact",
                                compute_dtype=F32, on_violation="error")
    _assert_same_mesh(giga, ref)


def test_steep_field_exact_by_construction():
    """f = 20 x0 (tests/test_sparse_grid.py): the adaptive margin selects
    its shell without a certificate violation; on_violation="dense" agrees."""
    jm = JaxImplicitNet(d_in=3, hidden_dims=(8,), skip_in=(), beta=100.0)
    params = _steep_plane_params(jm)
    tm = ImplicitNet(d_in=3, hidden_dims=(8,), skip_in=(), beta=100.0)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    ref = _one_shot(fused_grid_eval(tm, 32, compute_dtype=F32).numpy())
    for on_violation in ("error", "dense"):
        giga = ge.extract_mesh_giga(tm, 32, slab=16, compute_dtype=F32,
                                    on_violation=on_violation, wire="exact")
        _assert_same_mesh(giga, ref)


def test_seam_fuzz_random_fields():
    """Band-limited noise puts crossings on the slab planes, vertices on
    seam edges and cells across two slabs; the merged mesh still equals one
    pass (tests/test_giga_extract.py:320)."""
    rng = np.random.default_rng(7)
    n = 24
    ax = np.linspace(0, 6, n)
    ix = np.minimum(ax.astype(np.int32), 5)
    fx = (ax - ix).astype(np.float32)

    def lerp(a, axis):
        lo, hi = np.take(a, ix, axis=axis), np.take(a, np.minimum(ix + 1, 6), axis=axis)
        shape = [1, 1, 1]
        shape[axis] = -1
        return lo + (hi - lo) * fx.reshape(shape)

    for _ in range(4):
        vol = lerp(lerp(lerp(rng.standard_normal((7, 7, 7)).astype(np.float32), 0), 1), 2)
        for wire in ("exact", "packed"):
            ref = _one_shot(vol, wire=wire)
            assert len(ref[1]) > 0
            giga = ge.extract_mesh_giga(None, n, slab=8, wire=wire,
                                        vol_fn=lambda x0, sx: vol[x0:x0 + sx])
            _assert_same_mesh(giga, ref)


def test_validates_inputs():
    tm = _pair()[2]
    with pytest.raises(ValueError, match="divisible"):
        ge.extract_mesh_giga(tm, 33, slab=16)
    with pytest.raises(ValueError, match="divisible"):
        ge.extract_mesh_giga(tm, 32, slab=12)
    with pytest.raises(ValueError, match="slot space"):
        ge.extract_mesh_giga(None, 1024, slab=1024, vol_fn=lambda x0, sx: None)
    with pytest.raises(ValueError, match="on_violation"):
        ge.extract_mesh_giga(tm, 32, on_violation="ignore")
    with pytest.raises(ValueError, match="ImplicitNet"):
        ge.extract_mesh_giga(torch.nn.Linear(3, 1), 32)


@pytest.mark.parametrize("wire", ["exact", "packed"])
def test_hash_mlp_slabs_equal_one_pass_and_jax(wire):
    """A HashMLP's default evaluator is the separable x-slab one (float32
    whatever compute_dtype says): the merged mesh equals one pass over the
    x-slab evaluator's whole volume (a plane's bits do not depend on the
    slab), and the JAX extractor's on the same weights."""
    kw = dict(n_levels=4, log2_table_size=9, base_resolution=4, max_resolution=32,
              hidden_dim=16, num_layers=2)
    jm = HashMLP(**kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = TorchHashMLP(**kw)
    tm.load_state_dict(params_from_jax(params, tm))
    n = 32
    giga = ge.extract_mesh_giga(tm, n, slab=8, wire=wire, compute_dtype=torch.bfloat16)
    ref = _one_shot(hash_grid_eval_x_slab(tm, 0, n, n), wire=wire)
    assert len(ref[1]) > 0
    _assert_same_mesh(giga, ref)
    jax_giga = jge.extract_mesh_giga(jm, params, n, slab=8, wire=wire)
    assert len(giga[1]) == len(jax_giga[1])
    np.testing.assert_allclose(canon(*giga), canon(*jax_giga), atol=1e-5)


def test_vertex_cap_overflow_retries_with_halved_slabs(monkeypatch, capsys):
    """A slab over the per-pass vertex cap is redone at half the slab size,
    with the same result."""
    n = 40
    vol = _dense(n)

    def most_vertices(slab):
        return max(len(md.marching_tets_device(torch.from_numpy(vol[x0:x0 + sx]))[0])
                   for x0, sx in ge._slab_plan(n, slab))

    cap = most_vertices(8)
    assert cap < most_vertices(16)
    refs = {wire: _one_shot(vol, wire=wire) for wire in ("exact", "packed")}
    monkeypatch.setattr(md, "VERTEX_CAP", cap)
    for wire, ref in refs.items():
        giga = ge.extract_mesh_giga(None, n, slab=16, wire=wire,
                                    vol_fn=lambda x0, sx: torch.from_numpy(vol[x0:x0 + sx]))
        assert "retrying with slab=8" in capsys.readouterr().out
        _assert_same_mesh(giga, ref)


def test_empty_level_set():
    verts, faces = ge.extract_mesh_giga(None, 24, slab=8,
                                        vol_fn=lambda x0, sx: torch.ones((sx, 24, 24)))
    assert verts.shape == (0, 3) and faces.shape == (0, 3)
