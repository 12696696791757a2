"""The port's multi-file sampler against the JAX package's.

The shards are .ply files in sub-directories (one of them corrupt); each
package walks its own copy of the tree, so each computes its own
max_min.txt. Both draw the surface samples from the same ``default_rng``
stream in numpy float64, so surface.csv read back equals the JAX file: the
same rows, the row index restarting at 0 in each shard's block, values
within 1e-12 (the port writes 17 significant digits, pandas the shortest
round trip: both read back to the same float64)."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from sdf_representation_tpu.sampling import distributed as jax_distributed
from sdf_representation_tpu_torch.geometry.mesh_io import Mesh, load_mesh, save_mesh
from sdf_representation_tpu_torch.geometry.primitives import make_box, make_icosphere
from sdf_representation_tpu_torch.sampling import distributed

TOL = 1e-12


def _shards(root):
    """Five good shards in two sub-directories and one corrupt file."""
    (root / "a").mkdir(parents=True)
    (root / "b" / "c").mkdir(parents=True)
    for i, r in enumerate((0.3, 0.5, 0.7)):
        save_mesh(make_icosphere(1, r), str(root / "a" / f"sphere{i}.ply"))
    box = make_box((0.4, 0.2, 0.9))
    save_mesh(Mesh(box.vertices + 0.25, box.faces), str(root / "b" / "box.ply"))
    save_mesh(make_icosphere(0, 1.2), str(root / "b" / "c" / "ico.ply"))
    (root / "b" / "broken.ply").write_text("ply\nformat ascii 1.0\nelement vertex 3\nend_header\n1 2\n")
    return root


def _trees(tmp_path):
    ours = _shards(tmp_path / "geo_ours")
    theirs = tmp_path / "geo_theirs"
    shutil.copytree(ours, theirs)
    return ours, theirs


def _journal(path):
    return (path / "processed_files.log").read_text().splitlines()


def _read(path):
    return pd.read_csv(path / "surface.csv", index_col=0)


def _assert_same_csv(ours, theirs):
    got, want = _read(ours), _read(theirs)
    assert list(got.columns) == list(want.columns) == ["x", "y", "z", "S", "nx", "ny", "nz"]
    np.testing.assert_array_equal(got.index, want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=TOL)
    return got


def test_compute_min_max_order_and_cache(tmp_path):
    ours, theirs = _trees(tmp_path)
    lo, hi = distributed.compute_min_max(str(ours))
    assert (lo, hi) == jax_distributed.compute_min_max(str(theirs))
    verts = np.concatenate([load_mesh(str(p)).vertices for p in ours.rglob("*.ply")
                            if p.name != "broken.ply"])
    assert (lo, hi) == (verts.min(), verts.max()) and lo < 0 < hi
    assert (ours / "max_min.txt").read_text() == (theirs / "max_min.txt").read_text()
    # the cache is read back, not recomputed
    (ours / "max_min.txt").write_text("-3.5 2.25\n")
    assert distributed.compute_min_max(str(ours)) == (-3.5, 2.25)


@pytest.mark.parametrize("surface_points,include_vertices", [(0, True), (2, True), (3, False)])
def test_surface_csv_equals_jax(tmp_path, surface_points, include_vertices, capsys):
    ours_geo, theirs_geo = _trees(tmp_path)
    kw = dict(num_points_surface=surface_points, include_vertices=include_vertices, seed=5)
    path = distributed.write_signed_distance_distributed(str(ours_geo), str(tmp_path / "ours"), **kw)
    assert "skipping corrupt mesh" in capsys.readouterr().out
    jax_distributed.write_signed_distance_distributed(str(theirs_geo), str(tmp_path / "theirs"), **kw)
    assert path == str(tmp_path / "ours" / "surface.csv")
    got = _assert_same_csv(tmp_path / "ours", tmp_path / "theirs")
    # the corrupt shard is journalled too
    assert _journal(tmp_path / "ours") == _journal(tmp_path / "theirs")
    assert len(_journal(tmp_path / "ours")) == 6 and "b/broken.ply" in _journal(tmp_path / "ours")
    # one block per good shard, each indexed from 0
    sizes = [42, 42, 42, 8, 12]  # icosphere(1) x 3, the box's welded vertices, icosphere(0)
    faces = [80, 80, 80, 12, 20]
    rows = [include_vertices * v + surface_points * f for v, f in zip(sizes, faces)]
    assert len(got) == sum(rows)
    starts = np.flatnonzero(np.asarray(got.index) == 0)
    np.testing.assert_array_equal(np.diff(np.append(starts, len(got))), rows)
    lines = (tmp_path / "ours" / "surface.csv").read_text().splitlines()
    assert lines[0] == ",x,y,z,S,nx,ny,nz" and lines.count(lines[0]) == 1
    assert np.all(got[["S", "nx", "ny", "nz"]].to_numpy() == 0)
    # the 40% margin: every point within [-1, 1] after scaling
    assert np.abs(got[["x", "y", "z"]].to_numpy()).max() <= 1 / 1.4 + 1e-12


def test_resume_appends_only_new_shards(tmp_path):
    ours_geo, theirs_geo = _trees(tmp_path)
    for geo, out, fn in ((ours_geo, "ours", distributed.write_signed_distance_distributed),
                         (theirs_geo, "theirs", jax_distributed.write_signed_distance_distributed)):
        fn(str(geo), str(tmp_path / out), num_points_surface=1)
    first = (tmp_path / "ours" / "surface.csv").read_text()
    # a second call finds every file journalled and appends nothing
    distributed.write_signed_distance_distributed(str(ours_geo), str(tmp_path / "ours"),
                                                  num_points_surface=1)
    assert (tmp_path / "ours" / "surface.csv").read_text() == first
    # a new shard is appended alone (the cached bbox stays)
    for geo, out, fn in ((ours_geo, "ours", distributed.write_signed_distance_distributed),
                         (theirs_geo, "theirs", jax_distributed.write_signed_distance_distributed)):
        save_mesh(make_icosphere(1, 0.9), str(geo / "a" / "sphere9.ply"))
        fn(str(geo), str(tmp_path / out), num_points_surface=1)
    got = _assert_same_csv(tmp_path / "ours", tmp_path / "theirs")
    assert (tmp_path / "ours" / "surface.csv").read_text().startswith(first)
    assert len(got) == len(pd.read_csv(pd.io.common.StringIO(first), index_col=0)) + 42 + 80
    assert _journal(tmp_path / "ours")[-1] == os.path.join("a", "sphere9.ply")


def test_hosts_journal_disjoint_files(tmp_path):
    ours_geo, theirs_geo = _trees(tmp_path)
    journals = []
    for host in (0, 1):
        out = tmp_path / f"host{host}"
        distributed.write_signed_distance_distributed(str(ours_geo), str(out), host_id=host,
                                                      num_hosts=2, num_points_surface=1)
        jax_distributed.write_signed_distance_distributed(
            str(theirs_geo), str(tmp_path / f"jax_host{host}"), host_id=host, num_hosts=2,
            num_points_surface=1)
        _assert_same_csv(out, tmp_path / f"jax_host{host}")  # seeded with seed + host_id
        journals.append(set(_journal(out)))
    assert not journals[0] & journals[1]
    files = {os.path.relpath(os.path.join(d, f), ours_geo)
             for d, _, fs in os.walk(ours_geo) for f in fs if f.endswith(".ply")}
    assert journals[0] | journals[1] == files
