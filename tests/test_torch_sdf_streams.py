"""The port's distance and winding streams (plain path on the CPU) against the
JAX package's Pallas stream kernels in interpret mode, on the same points,
tables and step schedule, dense and sparse (as tests/test_pallas_streams.py).

Tolerances, those of tests/test_pallas_streams.py: d^2 rtol 1e-5 / atol 1e-7
(f32 rounding order of the dots); winners equal except on ties that the f64
oracle proves equidistant (icospheres are tie-heavy); winding rtol 1e-4 /
atol 1e-3 (near plane-degenerate pairs atan2 amplifies last-ulp skew to
~3e-4; the contract is the sign at a 2 pi margin)."""

import numpy as np
import pytest
import torch

from sdf_representation_tpu.geometry.primitives import make_icosphere
from sdf_representation_tpu.ops import pallas_streams
from sdf_representation_tpu.ops.sdf_culled import _morton_order, _stream_steps
from sdf_representation_tpu.ops.sdf_exact import _triangle_tables as jax_triangle_tables
from sdf_representation_tpu_torch.ops import sdf_exact, sdf_streams

torch.set_num_threads(2)
RADIUS = 0.6


def _setup(keep_frac, n_pts=1024, M=256, tri_chunk=256, seed=0):
    mesh = make_icosphere(subdivisions=3, radius=RADIUS)  # 1280 faces
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    pts = pts[_morton_order(pts)]
    B = n_pts // M
    P_blocks = pts.reshape(B, M, 3)
    tables, F = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, tri_chunk)
    C = tables["a"].shape[0]
    keep = rng.uniform(size=(B, C)) < keep_frac
    keep[:, 0] = True  # every block keeps at least one chunk
    sb, sc, _ = sdf_streams.stream_steps(keep, B)
    return mesh, P_blocks, sb, sc, tables, tri_chunk, B


def test_tables_steps_and_packing_equal_the_jax_package():
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(0.6)
    theirs, F = jax_triangle_tables(mesh.vertices.astype(np.float64), mesh.faces, tri_chunk)
    assert set(theirs) == set(tables) and F == len(mesh.faces)
    for key in theirs:
        np.testing.assert_array_equal(tables[key], theirs[key])
    np.testing.assert_array_equal(sdf_streams.pack_dist_table(tables, tri_chunk),
                                  pallas_streams.pack_dist_table(theirs, tri_chunk))
    np.testing.assert_array_equal(sdf_streams.pack_wind_table(tables, tri_chunk),
                                  pallas_streams.pack_wind_table(theirs, tri_chunk))
    keep = np.random.default_rng(5).uniform(size=(7, 5)) < 0.5
    for got, want in zip(sdf_streams.stream_steps(keep, 7), _stream_steps(keep, 7)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep_frac", [1.0, 0.6], ids=["dense", "sparse"])
def test_dist_stream_matches_pallas_kernel(keep_frac):
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(keep_frac)
    ref_d2, ref_best = pallas_streams.dist_stream_pallas(
        P_blocks, sb, sc, tables, tri_chunk, interpret=True)
    got_d2, got_best = sdf_streams.dist_stream(torch.from_numpy(P_blocks), sb, sc, tables,
                                               tri_chunk)
    assert got_d2.shape == (B + 1, P_blocks.shape[1]) and got_best.dtype == torch.int32
    np.testing.assert_allclose(got_d2.numpy()[:B], np.asarray(ref_d2)[:B], rtol=1e-5, atol=1e-7)
    gb = got_best.numpy()[:B].reshape(-1)
    rb = np.asarray(ref_best)[:B].reshape(-1)
    diff = np.nonzero(gb != rb)[0]
    assert len(diff) < 0.08 * len(gb)
    if len(diff):  # different winners must be equidistant under the f64 oracle
        pts = P_blocks.reshape(-1, 3)[diff].astype(np.float64)
        tri = mesh.vertices[mesh.faces]
        da = np.linalg.norm(pts - sdf_exact.closest_point_on_triangles(pts, tri[gb[diff]]), axis=1)
        db = np.linalg.norm(pts - sdf_exact.closest_point_on_triangles(pts, tri[rb[diff]]), axis=1)
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)
    # the sink row is never written by a live step
    assert torch.isinf(got_d2[B]).all() and (got_best[B] == 0).all()


@pytest.mark.parametrize("keep_frac", [1.0, 0.6], ids=["dense", "sparse"])
def test_wind_stream_matches_pallas_kernel(keep_frac):
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(keep_frac, seed=1)
    ref = pallas_streams.wind_stream_pallas(P_blocks, sb, sc, tables, tri_chunk, interpret=True)
    got = sdf_streams.wind_stream(torch.from_numpy(P_blocks), sb, sc, tables, tri_chunk)
    np.testing.assert_allclose(got.numpy()[:B], np.asarray(ref)[:B], rtol=1e-4, atol=1e-3)
    assert (got[B] == 0).all()
    if keep_frac == 1.0:  # every chunk visited: 4 pi inside, 0 outside
        r = np.linalg.norm(P_blocks.reshape(-1, 3), axis=1)
        w = got.numpy()[:B].reshape(-1) / (4 * np.pi)
        np.testing.assert_allclose(w[r < RADIUS - 0.02], 1.0, atol=1e-4)
        np.testing.assert_allclose(w[r > RADIUS + 0.02], 0.0, atol=1e-4)


def test_streams_match_the_matmul_sweep_on_a_ragged_tiling():
    """tri_chunk 200 (a ragged last 128-strip on the card) and 300-point
    blocks: the streams against the matmul-form all-pairs sweep."""
    mesh = make_icosphere(subdivisions=2, radius=0.5)  # 320 faces -> 2 chunks of 200
    rng = np.random.default_rng(2)
    P = torch.from_numpy(rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32))
    tables, F = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 200)
    sb, sc, S = sdf_streams.stream_steps(np.ones((2, 2), bool), 2)
    assert S == 4 and sdf_streams.stream_tiling_ok(200, 300)
    d2, best = sdf_streams.dist_stream(P, sb, sc, tables, 200)
    w = sdf_streams.wind_stream(P, sb, sc, tables, 200)
    dev_tables = {k: torch.from_numpy(v) for k, v in tables.items()}
    for b in range(2):
        ref_d2, ref_best, ref_w = sdf_exact._sdf_point_block(P[b], dev_tables, 200)
        np.testing.assert_allclose(d2[b].numpy(), ref_d2.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(w[b].numpy(), ref_w.numpy(), rtol=1e-4, atol=1e-3)
        assert (best[b] < F).all()  # padding triangles never win
        assert (best[b] != ref_best).float().mean() < 0.08


def test_unvisited_blocks_sink_steps_and_step_order():
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(1.0)
    C = tables["a"].shape[0]
    keep = np.ones((B, C), bool)
    keep[2] = False  # block 2 is never visited
    sb, sc, S = sdf_streams.stream_steps(keep, B)
    assert len(sb) > S and (sb[S:] == B).all()  # padded with sink steps
    offs, chunks = sdf_streams.block_ranges(sb, sc, B)
    assert offs.tolist() == [0, C, 2 * C, 2 * C, 3 * C] and len(chunks) == S
    P = torch.from_numpy(P_blocks)
    d2, best = sdf_streams.dist_stream(P, sb, sc, tables, tri_chunk)
    w = sdf_streams.wind_stream(P, sb, sc, tables, tri_chunk)
    assert torch.isinf(d2[2]).all() and (best[2] == 0).all() and (w[2] == 0).all()
    assert torch.isfinite(d2[[0, 1, 3]]).all()
    # steps given in another order reach the same blocks (stable per block)
    order = np.random.default_rng(0).permutation(len(sb))
    order = order[np.argsort(sc[order], kind="stable")]  # chunks still ascending per block
    d2b, bestb = sdf_streams.dist_stream(P, sb[order], sc[order], tables, tri_chunk)
    assert torch.equal(d2, d2b) and torch.equal(best, bestb)


def test_wrappers_refuse_bad_inputs_and_count_no_cpu_launch():
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(1.0)
    sdf_streams.reset_launches()
    with pytest.raises(ValueError, match="float32"):
        sdf_streams.dist_stream(torch.from_numpy(P_blocks).double(), sb, sc, tables, tri_chunk)
    with pytest.raises(ValueError, match=r"\(B, M, 3\)"):
        sdf_streams.wind_stream(torch.zeros(4, 3), sb, sc, tables, tri_chunk)
    assert not sdf_streams.stream_tiling_ok(0, 256)
    sdf_streams.wind_stream(torch.from_numpy(P_blocks[:1]), sb[:1], sc[:1], tables, tri_chunk)
    assert set(sdf_streams.LAUNCHES.values()) == {0}  # the CPU path launches no kernel


# ---------------------------------------------------------------------------
# sharded streams (kernels 6 and 7): contiguous block ranges over a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_streams_bit_equal_the_single_device_streams(n_dev):
    """Every point sees the same chunks in the same order: d2, winners and
    solid angles equal one launch over all blocks bit for bit."""
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(0.6, n_pts=2048)
    P = torch.from_numpy(P_blocks)
    d2, best = sdf_streams.dist_stream(P, sb, sc, tables, tri_chunk)
    w = sdf_streams.wind_stream(P, sb, sc, tables, tri_chunk)
    mesh_devices = ("cpu",) * n_dev
    sd2, sbest = sdf_streams.dist_stream_sharded(P_blocks, sb, sc, tables, tri_chunk, mesh_devices)
    sw = sdf_streams.wind_stream_sharded(P, sb, sc, tables, tri_chunk, mesh_devices)
    assert sd2.shape == sbest.shape == sw.shape == (B, P_blocks.shape[1])
    assert isinstance(sd2, np.ndarray) and sbest.dtype == np.int32
    np.testing.assert_array_equal(sd2, d2[:B].numpy())
    np.testing.assert_array_equal(sbest, best[:B].numpy())
    np.testing.assert_array_equal(sw, w[:B].numpy())


def test_per_device_steps_equal_the_jax_package():
    keep = np.random.default_rng(9).uniform(size=(16, 7)) < 0.4
    keep[5] = False  # a block with no step
    sb, sc, _ = sdf_streams.stream_steps(keep, 16)
    for n_dev in (1, 2, 4, 8, 16):
        ours = sdf_streams.per_device_steps(sb, sc, 16, n_dev)
        theirs = pallas_streams._per_device_steps(sb, sc, 16, n_dev)
        for got, want in zip(ours, theirs):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_sharded_streams_match_the_sharded_pallas_kernels():
    """The port's sharded streams against dist_stream_pallas_sharded and
    wind_stream_pallas_sharded in interpret mode on the eight virtual CPU
    devices, one schedule. The Pallas kernels round their dots in another
    order than the port's plain tiles (the single-device parity above), so
    the limits are those of the single-device tests: d2 rtol 1e-5 / atol
    1e-7, winners equal but for ties the f64 oracle proves, solid angles
    rtol 1e-4 / atol 1e-3; on the inputs of those tests (seed 0 for the
    distance, 1 for the winding)."""
    from sdf_representation_tpu.parallel.mesh import get_mesh

    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(0.6, n_pts=2048, seed=1)
    ref_w = pallas_streams.wind_stream_pallas_sharded(
        P_blocks, sb, sc, tables, tri_chunk, get_mesh(), interpret=True)
    w = sdf_streams.wind_stream_sharded(P_blocks, sb, sc, tables, tri_chunk, ("cpu",) * 8)
    np.testing.assert_allclose(w, ref_w, rtol=1e-4, atol=1e-3)
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(0.6, n_pts=2048)
    ref_d2, ref_best = pallas_streams.dist_stream_pallas_sharded(
        P_blocks, sb, sc, tables, tri_chunk, get_mesh(), interpret=True)
    d2, best = sdf_streams.dist_stream_sharded(P_blocks, sb, sc, tables, tri_chunk, ("cpu",) * 8)
    np.testing.assert_allclose(d2, ref_d2, rtol=1e-5, atol=1e-7)
    gb, rb = best.reshape(-1), ref_best.reshape(-1)
    diff = np.nonzero(gb != rb)[0]
    assert len(diff) < 0.08 * len(gb)
    pts = P_blocks.reshape(-1, 3)[diff].astype(np.float64)
    tri = mesh.vertices[mesh.faces]
    da = np.linalg.norm(pts - sdf_exact.closest_point_on_triangles(pts, tri[gb[diff]]), axis=1)
    db = np.linalg.norm(pts - sdf_exact.closest_point_on_triangles(pts, tri[rb[diff]]), axis=1)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_culled_sharded_matches_the_jax_sharded_culled_method():
    """signed_distance_culled over the eight virtual CPU devices with the
    Pallas kernels (use_pallas=True: without it the JAX package takes its
    XLA streams on the CPU and never the sharded branch) against the port's
    over ("cpu",) * 8: rtol 1e-5 / atol 1e-6, identical signs."""
    from sdf_representation_tpu.ops.sdf_culled import signed_distance_culled
    from sdf_representation_tpu.parallel.mesh import get_mesh
    from sdf_representation_tpu_torch.ops import sdf_culled
    from sdf_representation_tpu_torch.parallel.mesh import get_mesh as port_mesh

    m = make_icosphere(subdivisions=4, radius=0.6)
    pts = np.random.default_rng(11).uniform(-1, 1, (4096, 3))
    ref, _ = signed_distance_culled(pts, m, point_chunk=512, tri_chunk=256, use_pallas=True,
                                    device_mesh=get_mesh())
    got, _ = sdf_culled.signed_distance_culled(pts, m, point_chunk=512, tri_chunk=256,
                                               device="cpu", devices=port_mesh(devices=["cpu"] * 8))
    assert sdf_culled.LAST_COUNTS["shards"] == 8
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.all(np.sign(got) == np.sign(ref))


def test_sharded_streams_refuse_bad_meshes_and_count_no_cpu_launch():
    mesh, P_blocks, sb, sc, tables, tri_chunk, B = _setup(1.0)  # 4 blocks
    sdf_streams.reset_launches()
    with pytest.raises(ValueError, match="split evenly"):
        sdf_streams.dist_stream_sharded(P_blocks, sb, sc, tables, tri_chunk, ("cpu",) * 3)
    with pytest.raises(ValueError, match="all cards or all CPU"):
        sdf_streams.wind_stream_sharded(P_blocks, sb, sc, tables, tri_chunk, ("cpu", "meta"))
    w = sdf_streams.wind_stream_sharded(P_blocks[:2], sb[:1], sc[:1], tables, tri_chunk,
                                        ("cpu",) * 2)
    assert w.shape == (2, P_blocks.shape[1])
    assert set(sdf_streams.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# host-side pieces of the kernels' launches (csrc/sdf_streams.cu): the
# distance kernel's table, the CTAs' block order, the polynomial atan2
# ---------------------------------------------------------------------------

def _kernel_form_d2(P: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(M, T) d^2 as dist_kernel's pair_d2 forms it from its table rows (the
    same operations and selects, rounded after each step: the kernel
    contracts some of them into FMAs)."""
    col = lambda k: rows[:, k]
    a, b, c = col(sdf_streams._K_A), col(sdf_streams._K_B), col(sdf_streams._K_C)
    E0 = [col(sdf_streams._K_E0 + k) for k in range(3)]
    E1 = [col(sdf_streams._K_E1 + k) for k in range(3)]
    w = [P[:, k:k + 1] - col(sdf_streams._K_V0 + k) for k in range(3)]
    d = -((w[0] * E0[0] + w[1] * E0[1]) + w[2] * E0[2])
    e = -((w[0] * E1[0] + w[1] * E1[1]) + w[2] * E1[2])
    s_raw, t_raw = b * e - c * d, b * d - a * e
    inside = (s_raw + t_raw) <= col(sdf_streams._K_DET)
    s_neg, t_neg = s_raw < 0, t_raw < 0
    s_edge = torch.clamp(-d * col(sdf_streams._K_INV_A), 0, 1)
    t_edge = torch.clamp(-e * col(sdf_streams._K_INV_C), 0, 1)
    ed = e - d
    n_s, n_t = col(sdf_streams._K_CB) + ed, col(sdf_streams._K_AB) - ed
    s_diag = torch.clamp(n_s * col(sdf_streams._K_INV_DEN), 0, 1)
    t_diag = torch.clamp(n_t * col(sdf_streams._K_INV_DEN), 0, 1)
    W, zero, inv_det = torch.where, torch.zeros_like(d), col(sdf_streams._K_INV_DET)
    s_in = W(t_neg, s_edge, W(s_neg, zero, s_raw * inv_det))
    t_in = W(t_neg, W(s_neg & (d >= 0), t_edge, zero), W(s_neg, t_edge, t_raw * inv_det))
    r6 = t_neg & ~s_neg
    s_out = W(r6, W(n_t > 0, 1 - t_diag, s_edge), s_diag)
    t_out = W(r6, t_diag, W(s_neg & ~(n_s > 0), t_edge, 1 - s_diag))
    s, t = W(inside, s_in, s_out), W(inside, t_in, t_out)
    dk = [w[k] - t * E1[k] - s * E0[k] for k in range(3)]
    return (dk[0] * dk[0] + dk[1] * dk[1]) + dk[2] * dk[2]


def test_dist_kernel_table_holds_the_eberly_terms():
    """The distance kernel's rows: the triangle constants as packed, and the
    per-triangle terms of _eberly_st in its own expressions, bit for bit;
    padding rows have no edges and v0.x = 1e20."""
    mesh = make_icosphere(subdivisions=2, radius=RADIUS)  # 320 faces -> 2 chunks of 256
    tables, F = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 256)
    rows = torch.from_numpy(sdf_streams.pack_dist_kernel_table(tables, 256)).reshape(-1, sdf_streams._K_ROWS)
    t = {k: torch.from_numpy(v).reshape(-1, *v.shape[2:]) for k, v in tables.items()}
    live, pad = slice(0, F), slice(F, None)
    a, b, c = t["a"][live], t["b"][live], t["c"][live]
    det = torch.clamp_min(a * c - b * b, 1e-30)  # _eberly_st's expressions
    inv_a, inv_c = 1.0 / torch.clamp_min(a, 1e-30), 1.0 / torch.clamp_min(c, 1e-30)
    den = torch.clamp_min(a - 2.0 * b + c, 1e-30)
    want = {sdf_streams._K_A: a, sdf_streams._K_B: b, sdf_streams._K_C: c,
            sdf_streams._K_DET: det, sdf_streams._K_INV_DET: 1.0 / det,
            sdf_streams._K_INV_A: inv_a, sdf_streams._K_INV_C: inv_c,
            sdf_streams._K_INV_DEN: 1.0 / den, sdf_streams._K_CB: c - b,
            sdf_streams._K_AB: a - b}
    for k in range(3):
        want[sdf_streams._K_E0 + k] = t["E0"][live, k]
        want[sdf_streams._K_E1 + k] = t["E1"][live, k]
        want[sdf_streams._K_V0 + k] = t["v0"][live, k]
    for column, value in want.items():
        assert torch.equal(rows[live, column], value), column
    assert (rows[pad, sdf_streams._K_V0] == 1e20).all()
    assert (rows[pad, sdf_streams._K_E0:sdf_streams._K_E0 + 3] == 0).all()
    assert (rows[pad, sdf_streams._K_E1:sdf_streams._K_E1 + 3] == 0).all()
    P = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (64, 3)).astype(np.float32))
    assert torch.isinf(_kernel_form_d2(P, rows[pad])).all()  # padding never wins


@pytest.mark.parametrize("mesh_sub,tri_chunk", [(3, 256), (2, 200)])
def test_dist_kernel_form_holds_the_stream_limits(mesh_sub, tri_chunk):
    """dist_kernel's arithmetic (reciprocals, w = P - v0, its region selects),
    here rounded step by step, against the plain distance tile on points in
    the cube, on the surface and near it: d^2 rtol 1e-5 / atol 1e-7 and the
    first minimal face wins but for f64-oracle ties (the kernel's limits on
    the card)."""
    mesh = make_icosphere(subdivisions=mesh_sub, radius=RADIUS)
    rng = np.random.default_rng(mesh_sub)
    tri = mesh.vertices[mesh.faces]
    on = tri[rng.integers(0, len(tri), 256)]
    u = rng.uniform(size=(256, 2))
    u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
    on = on[:, 0] + u[:, :1] * (on[:, 1] - on[:, 0]) + u[:, 1:] * (on[:, 2] - on[:, 0])
    pts = np.concatenate([rng.uniform(-1, 1, (512, 3)), on, on * 1.01]).astype(np.float32)
    P = torch.from_numpy(pts)
    tables, F = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, tri_chunk)
    rows = torch.from_numpy(sdf_streams.pack_dist_kernel_table(tables, tri_chunk))
    packed = torch.from_numpy(sdf_streams.pack_dist_table(tables, tri_chunk))
    got = torch.cat([_kernel_form_d2(P, r) for r in rows], dim=1)
    want = torch.cat([sdf_streams._dist_tile(P, r) for r in packed], dim=1)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-7)
    gb, wb = got.argmin(1).numpy(), want.argmin(1).numpy()  # argmin: the first minimum
    differ = np.nonzero(gb != wb)[0]
    q = pts[differ].astype(np.float64)
    da = np.linalg.norm(q - sdf_exact.closest_point_on_triangles(q, tri[gb[differ]]), axis=1)
    db = np.linalg.norm(q - sdf_exact.closest_point_on_triangles(q, tri[wb[differ]]), axis=1)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_launch_order_covers_every_step_once_in_block_order():
    """CTAs walk blocks in launch_order: the longest chunk lists first, ties
    in block order; together they visit every live (block, chunk) step once,
    each block's chunks in step order."""
    rng = np.random.default_rng(4)
    B, C = 37, 23
    keep = rng.uniform(size=(B, C)) < rng.uniform(0, 1, (B, 1))
    keep[[3, 17]] = False  # blocks no step visits
    sb, sc, S = sdf_streams.stream_steps(keep, B)
    offs, chunks = sdf_streams.block_ranges(sb, sc, B)
    order = sdf_streams.launch_order(offs)
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(B))
    counts = np.diff(offs)[order]
    assert (np.diff(counts) <= 0).all()
    for n in np.unique(counts):  # equal counts keep block order
        same = order[counts == n]
        assert (np.diff(same) > 0).all()
    walked = [(int(b), int(c)) for b in order for c in chunks[offs[b]:offs[b + 1]]]
    steps = [(int(b), int(c)) for b, c in zip(sb[:S], sc[:S])]
    assert sorted(walked) == sorted(steps) and len(walked) == S
    for b in range(B):
        assert [c for bb, c in walked if bb == b] == [c for bb, c in steps if bb == b]
    assert {3, 17} <= set(order[counts == 0].tolist())  # empty lists go last


def test_atan2_poly_is_the_jax_kernels_bit_for_bit():
    """The port's copy of the JAX winding kernel's atan2 against
    pallas_streams._atan2 on the same float32 inputs: every quadrant, both
    axes, zeros, magnitudes from 1e-8 to 1e8 (no subnormal steps: XLA flushes
    them on the CPU, torch does not)."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    y = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)).astype(np.float32)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)).astype(np.float32)
    x[:64], y[64:128], x[128:160], y[128:160] = 0, 0, -1, 0
    got = sdf_streams.atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(pallas_streams._atan2(y, x))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_winding_with_the_polynomial_atan2_holds_the_limits_on_the_surface(monkeypatch):
    """wind_kernel rounds numer and denom as the plain tile does and takes
    the polynomial atan2: on points on the surface (where the table form
    leaves numer and denom near edges at rounding noise) and off it, that
    sum stays within rtol 1e-4 / atol 1e-3 of the plain one."""
    mesh = make_icosphere(subdivisions=3, radius=RADIUS)
    rng = np.random.default_rng(6)
    tri = mesh.vertices[mesh.faces]
    on = tri[rng.integers(0, len(tri), 1024)]
    u = rng.uniform(size=(1024, 2))
    u = np.where(u.sum(1, keepdims=True) > 1, 1 - u, u)
    on = on[:, 0] + u[:, :1] * (on[:, 1] - on[:, 0]) + u[:, 1:] * (on[:, 2] - on[:, 0])
    P = torch.from_numpy(np.concatenate([on, rng.uniform(-1, 1, (1024, 3))]).astype(np.float32))
    tables, _ = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 256)
    packed = torch.from_numpy(sdf_streams.pack_wind_table(tables, 256))
    want = sum(sdf_streams._wind_tile(P, r) for r in packed)
    monkeypatch.setattr(torch, "atan2", sdf_streams.atan2_poly)  # the tile, with the polynomial
    got = sum(sdf_streams._wind_tile(P, r) for r in packed)
    monkeypatch.undo()
    assert not torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_csrc_reads_the_tables_as_they_are_packed():
    """csrc/sdf_streams.cu's row widths are those the packers write."""
    import re

    from sdf_representation_tpu_torch import kernels

    src = (kernels.CSRC / "sdf_streams.cu").read_text()
    rows = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kDistRows", "kWindRows")}
    mesh = make_icosphere(subdivisions=1, radius=RADIUS)
    tables, _ = sdf_exact._triangle_tables(mesh.vertices, mesh.faces, 128)
    assert rows["kDistRows"] == sdf_streams._K_ROWS == sdf_streams.pack_dist_kernel_table(
        tables, 128).shape[-1]
    assert rows["kWindRows"] == sdf_streams._W_ROWS == sdf_streams.pack_wind_table(
        tables, 128).shape[-1]


def test_a_build_that_reads_other_table_rows_is_refused():
    layout = dict.fromkeys(sdf_streams._LAYOUT_KEYS, 1)
    layout.update(dist_rows=sdf_streams._K_ROWS, wind_rows=sdf_streams._W_ROWS)
    sdf_streams._check_layout(layout)
    for key in ("dist_rows", "wind_rows"):
        with pytest.raises(RuntimeError, match="floats a triangle"):
            sdf_streams._check_layout({**layout, key: 16})
