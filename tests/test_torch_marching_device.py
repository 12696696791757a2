"""The port's device marcher (ops/marching_device.py) on CPU tensors against
the JAX package's (on its CPU backend) on the same volumes: the exact wire
gives the same vertex slots and faces in the same order and t bit for bit in
f32; the packed wire gives the same words, hence the same decoded arrays,
and the same wire bytes. Against itself and the host marcher: the packed
ids equal the exact ones with t within the u16 quantum (1/65535), world
vertices within spacing/65535 (tests/test_marching.py:242-259), and the
canonical triangle soup equals the host path's (test_marching.py:94)."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_representation_tpu.ops import marching_device as jmd
from sdf_representation_tpu_torch.ops import marching_device as md
from sdf_representation_tpu_torch.ops.marching import marching_cubes

torch.set_num_threads(2)
CASES = ["sphere", "noise", "exact_zero", "empty"]


def _sphere(n, radius=0.5):
    ax = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - radius).astype(np.float32)


def _smoothed_noise(shape, seed):
    vol = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    for ax in range(3):
        vol = (np.roll(vol, 1, ax) + vol + np.roll(vol, -1, ax)) / 3
    return vol


@functools.cache
def _case(name):
    """(volume, level, spacing) of each case: the sphere at n = 40, smoothed
    noise on a 13x21x9 grid (no axis a multiple of 8) at level 0.1, a plane
    through the x = 5 grid points (values exactly at the level) and an empty
    level set."""
    if name == "sphere":
        return _sphere(40), 0.0, 2.0 / 39
    if name == "noise":
        return _smoothed_noise((13, 21, 9), 3), 0.1, 1.0
    if name == "exact_zero":
        ax = np.arange(12, dtype=np.float32)
        return np.meshgrid(ax, ax, ax, indexing="ij")[0] - 5.0, 0.0, 1.0
    return _sphere(16) + 10.0, 0.0, 1.0


@functools.cache
def _jax_wires(name):
    vol, level, _ = _case(name)
    return (jmd.marching_tets_device(jnp.asarray(vol), level),
            jmd.marching_tets_device_packed(jnp.asarray(vol), level))


def _canon_soup(verts, faces):
    """The mesh as a sorted triangle soup (tests/test_marching.py:94)."""
    tris = verts[faces].reshape(len(faces), 3, 3)
    order = np.lexsort((tris[:, :, 2], tris[:, :, 1], tris[:, :, 0]), axis=1)
    arr = np.take_along_axis(tris, order[:, :, None], axis=1).reshape(-1, 9)
    return arr[np.lexsort(arr.T[::-1])]


@pytest.mark.parametrize("name", CASES)
def test_exact_wire_matches_jax_in_order(name):
    vol, level, _ = _case(name)
    (js, jt, jf), _ = _jax_wires(name)
    vs, t, faces = md.marching_tets_device(torch.from_numpy(vol), level)
    assert vs.dtype == np.int64 and t.dtype == np.float64 and faces.dtype == np.int64
    np.testing.assert_array_equal(vs, js)
    np.testing.assert_array_equal(faces, jf.reshape(-1, 3))
    np.testing.assert_array_equal(t.astype(np.float32).view(np.int32),
                                  jt.astype(np.float32).view(np.int32))
    assert (len(faces) > 0) == (name != "empty")


@pytest.mark.parametrize("name", CASES)
def test_packed_wire_matches_jax(name):
    vol, level, _ = _case(name)
    _, (js, jt, jf, jwire) = _jax_wires(name)
    stages = {}
    vs, t, faces, wire = md.marching_tets_device_packed(torch.from_numpy(vol), level, stages)
    np.testing.assert_array_equal(vs, js)
    np.testing.assert_array_equal(faces, jf.reshape(-1, 3))
    np.testing.assert_array_equal(t, jt)
    assert wire == jwire
    assert set(stages) == {"march", "decode"}


@pytest.mark.parametrize("name", CASES)
def test_packed_wire_against_the_exact_wire(name):
    vol, level, sp = _case(name)
    vt = torch.from_numpy(vol)
    vs_e, t_e, f_e = md.marching_tets_device(vt, level)
    vs_p, t_p, f_p, wire = md.marching_tets_device_packed(vt, level)
    np.testing.assert_array_equal(vs_p, vs_e)
    np.testing.assert_array_equal(f_p, f_e)
    np.testing.assert_allclose(t_p, t_e, rtol=0, atol=1.0 / 65535)
    if name == "sphere":  # the wire is small: < 1/4 of the exact payload (4 B a value)
        assert wire < (vs_e.size + t_e.size + f_e.size) * 4 / 4
    ve, fe = md.marching_cubes_device(vt, level, (sp,) * 3, (-1.0,) * 3)
    vp, fp = md.marching_cubes_device(vt, level, (sp,) * 3, (-1.0,) * 3, wire="packed")
    np.testing.assert_array_equal(fp, fe)
    np.testing.assert_allclose(vp, ve, rtol=0, atol=sp / 65535 + 1e-12)


@pytest.mark.parametrize("name", CASES)
def test_device_soup_equals_the_host_marcher(name):
    vol, level, sp = _case(name)
    vh, fh = marching_cubes(vol, level, (sp,) * 3, (-1.0,) * 3)
    vd, fd = marching_cubes(torch.from_numpy(vol), level, (sp,) * 3, (-1.0,) * 3)
    assert len(fh) == len(fd) and len(vh) == len(vd)
    np.testing.assert_array_equal(_canon_soup(vh, fh), _canon_soup(vd, fd))
    if name == "exact_zero":  # every vertex on the plane x = 5 (world -1 + 5)
        np.testing.assert_array_equal(vd[:, 0], 4.0)


def test_device_mesh_closed_and_oriented():
    vol, level, sp = _case("sphere")
    verts, faces = marching_cubes(torch.from_numpy(vol), level, (sp,) * 3, (-1.0,) * 3,
                                  wire="packed")
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert np.all(counts == 2)
    tri = verts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centres = tri.mean(axis=1)
    assert np.mean(np.einsum("ij,ij->i", normals, centres) > 0) > 0.99


def test_guards():
    big = torch.zeros(1).expand(700, 700, 700)  # 700^3 * 7 >= 2^31, never touched
    with pytest.raises(ValueError, match="int32 slot space"):
        md.marching_tets_device(big)
    with pytest.raises(ValueError, match="int32 slot space"):
        md.marching_tets_device_packed(big)
    with pytest.raises(ValueError, match="wire"):
        md.marching_cubes_device(torch.from_numpy(_case("sphere")[0]), 0.0, (1.0,) * 3,
                                 (0.0,) * 3, wire="bits")
    v, f = md.marching_cubes_device(torch.ones(1, 8, 8), 0.0, (1.0,) * 3, (0.0,) * 3)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_vertex_cap_raises_the_budget_message(monkeypatch):
    vol = torch.from_numpy(_case("sphere")[0])
    count = len(md.marching_tets_device(vol)[0])
    monkeypatch.setattr(md, "VERTEX_CAP", count - 1)
    for march in (md.marching_tets_device, md.marching_tets_device_packed):
        with pytest.raises(ValueError, match="packed core-word budget"):
            march(vol)
    monkeypatch.setattr(md, "VERTEX_CAP", count)
    assert len(md.marching_tets_device_packed(vol)[0]) == count


def test_wire_decode_native_matches_numpy(native_build, monkeypatch):
    """The C++ decoder (native/src/wire_decode.cpp, loaded from the build
    where it exists) is np.array_equal with the port's numpy decode, at one
    thread and at five, on the port's own packed wires."""
    monkeypatch.setenv("SDF_WIRE_LIB", os.path.join(native_build, "libsdfnet_c.so"))
    cases = [((40, 40, 40), 0.0), ((13, 21, 9), 0.1), ((24, 33, 16), -0.05), ((8, 8, 8), 0.0)]
    try:
        for seed, (shape, level) in enumerate(cases):
            vol = torch.from_numpy(_smoothed_noise(shape, 11 + seed))
            monkeypatch.setenv("SDF_WIRE_DECODE", "numpy")
            md._WIRE_LIB = None
            assert md.wire_decoder() == "numpy"
            vs_n, t_n, f_n, _ = md.marching_tets_device_packed(vol, level)
            monkeypatch.setenv("SDF_WIRE_DECODE", "native")
            md._WIRE_LIB = None
            assert md.wire_decoder() == "native"
            for threads in ("1", "5"):
                monkeypatch.setenv("SDF_WIRE_THREADS", threads)
                vs_c, t_c, f_c, _ = md.marching_tets_device_packed(vol, level)
                np.testing.assert_array_equal(vs_c, vs_n)
                np.testing.assert_array_equal(f_c, f_n)
                np.testing.assert_array_equal(t_c, t_n)
            assert len(vs_n) > 0 and len(f_n) > 0, (shape, level)
    finally:
        md._WIRE_LIB = None  # later tests resolve the decoder anew
