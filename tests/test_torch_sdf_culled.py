"""The port's culled exact signed distance (plain streams and torch prepasses on
the CPU) against the JAX package's ops/sdf_culled.py on the same points and
meshes, and against the port's dense method, at the sizes of
tests/test_sdf_culled.py.

Tolerances. Against the JAX culled method (use_pallas=False): rtol 1e-5 /
atol 1e-6 on distances and identical signs, the limit tests/test_pallas_streams.py
holds two JAX stream paths to. Against the dense method: atol 1e-4, identical
signs, >= 99% of normals agreeing (tests/test_sdf_culled.py): the dipole far
field is approximate, and a tie between faces may pick either face's normal.
The keep matrices equal the JAX cull's: both compare sphere distances against
a 1e-3 slack, far above the last-ulp differences of the two frameworks' dots.
Each JAX reference is computed once per module."""

import numpy as np
import pytest
import torch

from sdf_representation_tpu.geometry.primitives import (
    box_sdf,
    make_box,
    make_icosphere,
    make_torus,
)
from sdf_representation_tpu.ops import sdf_culled as jax_culled
from sdf_representation_tpu.ops import sdf_exact as jax_exact
from sdf_representation_tpu_torch.geometry.mesh_io import Mesh, save_mesh
from sdf_representation_tpu_torch.ops import sdf_culled, sdf_exact
from sdf_representation_tpu_torch.ops import sdf_streams as ss

torch.set_num_threads(2)


def _culled(points, *mesh, **kw):
    return sdf_culled.signed_distance_culled(points, *mesh, device="cpu", **kw)


def _dense(points, mesh, **kw):
    return sdf_exact.signed_distance(points, mesh, method="dense", device="cpu", **kw)


def _same_sdf(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    assert np.all(np.sign(got) == np.sign(ref))


def _normals_agree(got_n, ref_n):
    assert np.mean(np.einsum("ij,ij->i", got_n, ref_n) > 0.999) > 0.99


@pytest.fixture(scope="module")
def ico():
    """icosphere(4) at radius 0.6 (5,120 faces), 4,096 uniform points, the
    port's culled result and the JAX culled reference."""
    mesh = make_icosphere(subdivisions=4, radius=0.6)
    pts = np.random.default_rng(0).uniform(-1, 1, (4096, 3))
    ref = jax_culled.signed_distance_culled(pts, mesh, point_chunk=512, tri_chunk=256,
                                            use_pallas=False)
    got = _culled(pts, mesh, point_chunk=512, tri_chunk=256)
    return mesh, pts, got, ref, dict(sdf_culled.LAST_COUNTS), dict(sdf_culled.LAST_STAGE_SECONDS)


def test_culled_matches_the_jax_culled_method(ico):
    mesh, pts, (got, got_n), (ref, ref_n), counts, stages = ico
    assert got.dtype == np.float64 and got_n.shape == (4096, 3)
    _same_sdf(got, ref)
    _normals_agree(got_n, ref_n)
    assert counts["blocks"] == 8 and counts["chunks"] == 20 and counts["shards"] == 1
    # uniform points in blocks of 512 keep (nearly) every chunk
    assert 8 <= counts["sum_kd"] <= 8 * 20 and 8 <= counts["sum_kw"] <= 8 * 20
    assert set(stages) == {
        "host_prep", "coarse_bound", "cull", "streams", "dipole", "refine"}


def test_culled_matches_the_dense_method(ico):
    mesh, pts, (got, got_n), *_ = ico
    ref, ref_n = _dense(pts, mesh, point_chunk=4096, tri_chunk=256)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(np.sign(got) == np.sign(ref))
    _normals_agree(got_n, ref_n)


@pytest.mark.parametrize("case", ["torus", "box"])
def test_culled_matches_jax_on_torus_and_box(case):
    mesh, tri_chunk = {"torus": (make_torus(), 128), "box": (make_box(), 4)}[case]
    pts = np.random.default_rng(1).uniform(-1, 1, (2000, 3))
    ref, _ = jax_culled.signed_distance_culled(pts, mesh, point_chunk=256, tri_chunk=tri_chunk,
                                               use_pallas=False)
    got, normals = _culled(pts, mesh, point_chunk=256, tri_chunk=tri_chunk)
    _same_sdf(got, ref)
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)
    if case == "box":
        np.testing.assert_allclose(got, box_sdf(pts), atol=1e-6)


def test_torus_far_field_signs():
    """Deep-inside / deep-outside points take the pure-dipole path."""
    pts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.9], [0.9, 0.9, 0.9],
                    [0.6, 0.0, 0.0], [0.0, 0.6, 0.0]])
    sdf, _ = _culled(pts, make_torus(), point_chunk=256, tri_chunk=128)
    assert np.all(sdf[:3] > 0) and np.all(sdf[3:] < 0)


def test_grid_ordered_points_survive_sort_and_unsort():
    mesh = make_icosphere(subdivisions=3, radius=0.5)
    ax = np.linspace(-1, 1, 24)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    ref, _ = _dense(pts, mesh, point_chunk=8192, tri_chunk=256)
    got, _ = _culled(pts, mesh, point_chunk=2048, tri_chunk=256)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(np.sign(got) == np.sign(ref))


def test_host_preparation_equals_the_jax_package():
    mesh = make_icosphere(subdivisions=3, radius=0.5)
    pts = np.random.default_rng(3).uniform(-1, 1, (1000, 3))
    np.testing.assert_array_equal(sdf_culled._morton_order(pts), jax_culled._morton_order(pts))
    # the points' sort on the device: the same permutation, duplicate codes included
    pts32 = np.concatenate([pts, pts[:300], pts[:1] * 0.999999]).astype(np.float32)
    np.testing.assert_array_equal(sdf_culled._morton_order(torch.from_numpy(pts32)).numpy(),
                                  jax_culled._morton_order(pts32))
    for ours, theirs in zip(sdf_culled._chunk_geometry(mesh.vertices, mesh.faces, 100),
                            jax_culled._chunk_geometry(mesh.vertices, mesh.faces, 100)):
        np.testing.assert_array_equal(ours, theirs)
    for name in ("_DIP_GROUP", "_CULL_SLACK", "_COARSE_EXACT_MAX_PAIRS", "_RESIDENT_MAX_FACES"):
        assert getattr(sdf_culled, name) == getattr(jax_culled, name)


def _spheres(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (40, 3))
    radii = rng.uniform(0.01, 0.2, 40)
    cbar = centers + rng.normal(scale=0.01, size=(40, 3))
    P_blocks = rng.uniform(-1, 1, (4, 64, 3)).astype(np.float32)
    ub = np.full(P_blocks.shape[:2], np.inf, np.float32)
    ub[1] = rng.uniform(0.2, 0.6, 64)  # a block with a coarse bound
    return P_blocks, ub, centers, radii, cbar


@pytest.mark.parametrize("group", [1024, 16], ids=["one_group", "three_groups"])
def test_cull_keep_matrices_equal_the_jax_cull(group):
    P_blocks, ub, centers, radii, cbar = _spheres(2)
    ref_kd, ref_kw = jax_culled._cull(P_blocks, ub, centers, radii, 2.0, cbar=cbar)
    kd, kw = sdf_culled._cull(torch.from_numpy(P_blocks), ub, centers, radii, 2.0, cbar=cbar,
                              group=group)
    np.testing.assert_array_equal(kd, ref_kd)
    np.testing.assert_array_equal(kw, ref_kw)
    assert 0 < kd.sum() < kd.size and 0 < kw.sum() < kw.size
    # conservative, by brute force: every chunk whose lower bound reaches a
    # point's upper bound is kept, and every beta-near chunk is exact-wound
    for b in range(len(P_blocks)):
        d = np.linalg.norm(P_blocks[b][:, None, :] - centers[None], axis=2)
        u = np.minimum((d + radii).min(axis=1), ub[b])
        assert set(np.nonzero(d - radii <= u[:, None])[1]) <= set(np.nonzero(kd[b])[0])
        assert set(np.nonzero(d <= 2.0 * radii)[1]) <= set(np.nonzero(kw[b])[0])


def _patch_and_uniform(n, seed):
    """Half the points in a small box at the surface of a radius-0.6 sphere
    (their blocks cull most chunks), half uniform in the cube."""
    rng = np.random.default_rng(seed)
    patch = rng.uniform([0.45, -0.15, -0.15], [0.75, 0.15, 0.15], (n // 2, 3))
    return np.concatenate([patch, rng.uniform(-1, 1, (n - n // 2, 3))]).astype(np.float32)


def test_the_winning_chunk_is_always_kept():
    mesh = make_icosphere(subdivisions=4, radius=0.6)
    pts = _patch_and_uniform(2048, 4)
    tri_chunk, M = 64, 256
    faces = mesh.faces[sdf_culled._morton_order(mesh.vertices[mesh.faces].mean(axis=1))]
    P = torch.from_numpy(pts[sdf_culled._morton_order(pts)].reshape(-1, M, 3))
    centers, radii, _, cbar = sdf_culled._chunk_geometry(mesh.vertices, faces, tri_chunk)
    kd, _ = sdf_culled._cull(P, np.full(P.shape[:2], np.inf, np.float32), centers, radii, 2.0,
                             cbar=cbar)
    tables, _ = sdf_exact._triangle_tables(mesh.vertices, faces, tri_chunk)
    sb, sc, _ = ss.stream_steps(np.ones(kd.shape, bool), len(kd))
    _, best = ss.dist_stream(P, sb, sc, tables, tri_chunk)
    winner_chunk = best[:len(kd)].numpy() // tri_chunk
    assert all(kd[b][winner_chunk[b]].all() for b in range(len(kd)))
    assert kd.mean() < 0.9  # and the cull does cull


@pytest.mark.parametrize("kind", ["exact", "spheres"])
def test_coarse_bounds_are_upper_bounds(kind):
    mesh = make_icosphere(subdivisions=3, radius=0.5)
    pts = np.random.default_rng(6).uniform(-1, 1, (2000, 3)).astype(np.float32)
    true, _ = _dense(pts, mesh)
    if kind == "exact":
        tables, _ = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 128)
        ub = sdf_culled._coarse_upper_bound(torch.from_numpy(pts), tables, 128).numpy()
        import jax.numpy as jnp

        ref = jax_culled._coarse_upper_bound(
            pts, {k: jnp.asarray(v) for k, v in tables.items()}, 128)
    else:
        centers, radii, _, _ = sdf_culled._chunk_geometry(mesh.vertices, mesh.faces, 128)
        ub = sdf_culled._coarse_upper_bound_spheres(torch.from_numpy(pts), centers, radii).numpy()
        ref = jax_culled._coarse_upper_bound_spheres(pts, centers, radii)
    assert ub.shape == (2000,) and ub.dtype == np.float32
    assert np.all(ub >= np.abs(true) - 1e-5)
    np.testing.assert_allclose(ub, ref, rtol=1e-5, atol=1e-6)  # the same bound, f32 rounding


def test_coarse_bounds_keep_distances_exact(monkeypatch):
    mesh = make_icosphere(subdivisions=3, radius=0.5)
    pts = np.random.default_rng(5).uniform(-1, 1, (2048, 3))
    ref, _ = _culled(pts, mesh, point_chunk=512, tri_chunk=128, coarse_bound=False)
    got, _ = _culled(pts, mesh, point_chunk=512, tri_chunk=128, coarse_bound=True)
    np.testing.assert_array_equal(got, ref)
    assert sdf_culled.LAST_COUNTS["coarse_bound"]
    monkeypatch.setattr(sdf_culled, "_COARSE_EXACT_MAX_PAIRS", 0.0)  # the sphere bound
    got, _ = _culled(pts, mesh, point_chunk=512, tri_chunk=128, coarse_bound=True)
    np.testing.assert_array_equal(got, ref)


def test_large_coordinate_scale_stays_exact():
    """The slacks scale with the scene: coordinates in the thousands keep
    the dense distances."""
    mesh = make_icosphere(subdivisions=3, radius=500.0)
    pts = np.random.default_rng(7).uniform(-1000, 1000, (2048, 3))
    ref, _ = _dense(pts, mesh, point_chunk=2048, tri_chunk=128)
    got, _ = _culled(pts, mesh, point_chunk=256, tri_chunk=128)
    _same_sdf(got, ref, atol=1e-3)


def test_finer_distance_chunks_give_the_same_distances():
    mesh = make_icosphere(subdivisions=4, radius=0.6)
    pts = np.random.default_rng(12).uniform(-1, 1, (2048, 3))
    ref, _ = _culled(pts, mesh, point_chunk=512, tri_chunk=512)
    got, _ = _culled(pts, mesh, point_chunk=512, tri_chunk=512, dist_tri_chunk=64)
    _same_sdf(got, ref)
    assert sdf_culled.LAST_COUNTS["dist_chunks"] == 80 and sdf_culled.LAST_COUNTS["chunks"] == 10


def test_streamed_slabs_match_the_resident_path(ico, monkeypatch):
    mesh, pts, (got, got_n), *_ = ico
    slabs, slab_n = sdf_culled.signed_distance_streamed(
        pts[:2048], mesh, point_chunk=512, tri_chunk=256, slab_faces=4096, device="cpu")
    ref, ref_n = _culled(pts[:2048], mesh, point_chunk=512, tri_chunk=256)
    _same_sdf(slabs, ref)
    _normals_agree(slab_n, ref_n)
    # past the residency cap signed_distance_culled streams slabs itself
    monkeypatch.setattr(sdf_culled, "_RESIDENT_MAX_FACES", 8192)  # 3 slabs
    delegated, _ = _culled(pts[:1024], mesh, point_chunk=256, tri_chunk=256)
    monkeypatch.undo()
    _same_sdf(delegated, _culled(pts[:1024], mesh, point_chunk=256, tri_chunk=256)[0])


def test_triangle_soup_distances_exact():
    """A non-watertight soup: distances still equal the dense method's on
    the culled and the streamed paths."""
    rng = np.random.default_rng(14)
    tris = rng.uniform(-0.5, 0.5, (100, 1, 3)) + rng.normal(scale=0.08, size=(100, 3, 3))
    verts, faces = tris.reshape(-1, 3), np.arange(300).reshape(100, 3)
    pts = rng.uniform(-1, 1, (1500, 3))
    ref, _ = sdf_exact.signed_distance(pts, verts, faces, method="dense", device="cpu")
    got, _ = _culled(pts, verts, faces, point_chunk=256, tri_chunk=16)
    np.testing.assert_allclose(np.abs(got), np.abs(ref), rtol=1e-5, atol=1e-6)
    got_s, _ = sdf_culled.signed_distance_streamed(pts, verts, faces, point_chunk=256,
                                                   tri_chunk=16, slab_faces=32, device="cpu")
    np.testing.assert_allclose(np.abs(got_s), np.abs(ref), rtol=1e-5, atol=1e-6)


def test_files_match_the_resident_path(tmp_path):
    """A watertight surface split over three files with their own vertex
    subsets, faces shuffled so no file is a coherent piece."""
    mesh = make_icosphere(subdivisions=3, radius=0.6)
    rng = np.random.default_rng(21)
    paths = []
    for s, part in enumerate(np.array_split(rng.permutation(len(mesh.faces)), 3)):
        used, inv = np.unique(mesh.faces[part], return_inverse=True)
        paths.append(tmp_path / f"shard{s}.ply")
        save_mesh(Mesh(mesh.vertices[used], inv.reshape(-1, 3)), str(paths[-1]))
    pts = rng.uniform(-1, 1, (1024, 3))
    ref, ref_n = _culled(pts, mesh, point_chunk=256, tri_chunk=128)
    got, got_n = sdf_culled.signed_distance_files(pts, paths, point_chunk=256, tri_chunk=128,
                                                  slab_faces=1024, device="cpu")
    _same_sdf(got, ref)
    _normals_agree(got_n, ref_n)


def test_files_union_of_components(tmp_path):
    a = make_icosphere(subdivisions=3, radius=0.25)
    paths = [tmp_path / "a.ply", tmp_path / "b.ply"]
    for path, dx in zip(paths, (-0.5, 0.5)):
        save_mesh(Mesh(a.vertices + np.array([dx, 0.0, 0.0]), a.faces), str(path))
    pts = np.random.default_rng(22).uniform(-1, 1, (2048, 3))
    got, _ = sdf_culled.signed_distance_files(pts, paths, point_chunk=256, tri_chunk=128,
                                              device="cpu")
    ana = np.minimum(np.linalg.norm(pts - [-0.5, 0, 0], axis=1),
                     np.linalg.norm(pts - [0.5, 0, 0], axis=1)) - 0.25
    band = np.abs(ana) > 5e-3  # facet error of level-3 spheres
    assert np.all(np.sign(got[band]) == np.sign(ana[band]))
    np.testing.assert_allclose(got, ana, atol=5e-3)


class _Dense(Exception):
    pass


@pytest.mark.parametrize("n_pts,n_faces,tri_chunk", [
    (16_777_216, 20_480, 1024),   # the 256^3 audit of configs/mesh_sdf.ini: culled at 512
    (1_050_000, 70_000, 1024),    # labelling a ~70k-face mesh: culled at 1024
    (100_000, 100_000, 1024),     # exactly 1e10 pairs
    (99_999, 100_000, 1024),      # one pair short
    (3_000_000, 4_095, 1024),     # too few faces for 32 chunks of 128
    (3_000_000, 4_096, 1024),     # 32 chunks of 128
    (2_500_000, 8_000, 256),      # shrinks from 256 to 128
    (64, 320, 16),                # small
])
def test_auto_picks_culled_where_the_jax_rule_does(monkeypatch, n_pts, n_faces, tri_chunk):
    """Both packages' "auto" on the same sizes, with the culled functions
    replaced by recorders and the dense sweeps stopped at their first step."""
    seen = {}

    def recorder(tag):
        def fake(points, vertices, faces, **kw):
            seen[tag] = kw["tri_chunk"]
            return np.zeros(len(points)), np.zeros((len(points), 3))
        return fake

    def stop(*args, **kw):
        raise _Dense

    monkeypatch.setattr(jax_culled, "signed_distance_culled", recorder("jax"))
    monkeypatch.setattr(sdf_culled, "signed_distance_culled", recorder("port"))
    monkeypatch.setattr(jax_exact, "_triangle_tables", stop)
    monkeypatch.setattr(sdf_exact, "_triangle_tables", stop)
    pts = np.zeros((n_pts, 3), np.float32)
    verts, faces = np.zeros((1, 3)), np.zeros((n_faces, 3), np.int64)
    for tag, call in (("jax", lambda: jax_exact.signed_distance(pts, verts, faces,
                                                                tri_chunk=tri_chunk)),
                      ("port", lambda: sdf_exact.signed_distance(pts, verts, faces,
                                                                 tri_chunk=tri_chunk,
                                                                 device="cpu"))):
        try:
            call()
        except _Dense:
            seen[tag] = "dense"
    assert seen["port"] == seen["jax"]


def test_culled_forwards_point_chunk_and_devices(monkeypatch):
    seen = {}

    def fake(points, vertices, faces, **kw):
        seen.update(kw)
        return np.zeros(len(points)), np.zeros((len(points), 3))

    monkeypatch.setattr(sdf_culled, "signed_distance_culled", fake)
    mesh = make_icosphere(subdivisions=2, radius=0.5)
    pts = np.zeros((8, 3), np.float32)
    sdf_exact.signed_distance(pts, mesh, method="culled", point_chunk=777, device="cpu",
                              devices=("cpu",) * 2)
    assert seen["point_chunk"] == 777 and seen["devices"] == ("cpu",) * 2
    assert seen["device"] == "cpu" and seen["tri_chunk"] == 1024
    seen.clear()
    sdf_exact.signed_distance(pts, mesh, method="culled", device="cpu")
    assert "point_chunk" not in seen  # the culled default stays


def test_forced_culled_matches_dense():
    mesh = make_icosphere(subdivisions=3, radius=0.5)
    pts = np.random.default_rng(5).uniform(-1, 1, (1500, 3))
    ref, _ = _dense(pts, mesh, point_chunk=2048, tri_chunk=256)
    got, _ = sdf_exact.signed_distance(pts, mesh, method="culled", tri_chunk=256, device="cpu")
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_empty_mesh_and_empty_points_on_both_paths():
    pts = np.random.default_rng(0).uniform(-1, 1, (16, 3)).astype(np.float32)
    empty = (np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    for method in ("dense", "culled"):
        d, g = sdf_exact.signed_distance(pts, *empty, method=method, device="cpu")
        assert d.shape == (16,) and g.shape == (16, 3)
        assert np.all(np.isinf(d)) and np.all(d > 0) and not g.any()
        d, g = sdf_exact.signed_distance(pts, *empty, method=method, device="cpu",
                                         return_device=True)
        assert isinstance(d, torch.Tensor) and torch.isinf(d).all()
    d, g = _culled(pts, *empty)
    assert np.all(np.isinf(d)) and g.shape == (16, 3)
    d, g = _culled(np.zeros((0, 3)), make_box())
    assert d.shape == (0,) and g.shape == (0, 3)
    d, g = sdf_culled.signed_distance_files(np.zeros((0, 3)), [], device="cpu")
    assert d.shape == (0,)


def test_prepasses_ignore_the_global_matmul_precision():
    """The trainer sets "medium" around its steps and the audit runs after
    it in the same process: the cull, both coarse bounds and the dipole must
    give the same results under "medium" as under "highest"."""
    mesh = make_icosphere(subdivisions=2, radius=0.6)
    pts = _patch_and_uniform(2048, 8)
    P = torch.from_numpy(pts.reshape(4, 512, 3))
    centers, radii, m, cbar = sdf_culled._chunk_geometry(mesh.vertices, mesh.faces, 16)
    tables, _ = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 16)
    ub = np.full((4, 512), np.inf, np.float32)

    def prepasses():
        kd, kw = sdf_culled._cull(P, ub, centers, radii, 2.0, cbar=cbar)
        far = sdf_culled._dipole_all_blocks(P, torch.from_numpy(~kw), cbar, m)
        return (kd, kw, far.numpy(),
                sdf_culled._coarse_upper_bound(P.reshape(-1, 3), tables, 16).numpy(),
                sdf_culled._coarse_upper_bound_spheres(P.reshape(-1, 3), centers, radii).numpy())

    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        medium = prepasses()
        torch.set_float32_matmul_precision("highest")
        highest = prepasses()
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(medium, highest):
        np.testing.assert_array_equal(a, b)
    assert (~medium[1]).any() and np.abs(medium[2]).max() > 0  # the dipole did run
