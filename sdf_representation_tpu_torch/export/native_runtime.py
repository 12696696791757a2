"""ctypes wrapper for the native C-ABI runtime (libsdfnet_c.so) — a copy of
sdf_representation_tpu/export/native_runtime.py.

The embedding surface of the framework: any FFI (here: Python ctypes, no
build step) loads the shared library and evaluates exported models —
``.sdfw`` (v1 float / v2 int8) through the threaded register-blocked C++
runtime, ``model.onnx`` through the wire-reading interpreter. This is the
consumer role the reference fills by linking LibTorch
(reference ops/conversion_test/main.cpp:1-40) or ONNX Runtime
(reference ops/DeepTrace/src/deeptrace.cpp:30-71) into each application.

Build: ``cmake -S native -B build && cmake --build build`` ->
``build/libsdfnet_c.so`` (``default_lib_path``, which ops/marching_device.py
also reads for its native wire decoder), or any other path given as
``lib_path``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_FPTR = ctypes.POINTER(ctypes.c_float)


def default_lib_path() -> str:
    """``<checkout>/build/libsdfnet_c.so``: where the cmake build of
    ``native/`` puts the library."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "build", "libsdfnet_c.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sdfnet_load.restype = ctypes.c_void_p
    lib.sdfnet_load.argtypes = [ctypes.c_char_p]
    lib.sdfnet_last_error.restype = ctypes.c_char_p
    lib.sdfnet_d_in.argtypes = [ctypes.c_void_p]
    lib.sdfnet_d_in.restype = ctypes.c_int
    lib.sdfnet_evaluate.argtypes = [
        ctypes.c_void_p, _FPTR, ctypes.c_size_t, _FPTR, _FPTR, ctypes.c_int,
    ]
    lib.sdfnet_evaluate.restype = ctypes.c_int
    lib.sdfnet_free.argtypes = [ctypes.c_void_p]
    return lib


class NativeSDF:
    """A loaded model behind the C ABI: ``NativeSDF(path).evaluate(pts)``.

    path: ``.sdfw`` or ``.onnx`` artifact (export/__main__.py writes both).
    lib_path: the shared library; defaults to ``<repo>/build/libsdfnet_c.so``.
    """

    def __init__(self, path: str, lib_path: Optional[str] = None):
        lp = lib_path or default_lib_path()
        if not os.path.exists(lp):
            raise FileNotFoundError(
                f"{lp} not built — run: cmake -S native -B build && "
                "cmake --build build"
            )
        self._lib = _bind(ctypes.CDLL(lp))
        self._h = self._lib.sdfnet_load(os.fspath(path).encode())
        if not self._h:
            raise RuntimeError(
                f"sdfnet_load({path}): "
                f"{self._lib.sdfnet_last_error().decode()}"
            )
        self.d_in = int(self._lib.sdfnet_d_in(self._h))

    def evaluate(
        self, pts: np.ndarray, gradients: bool = False, n_threads: int = 0
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(N, d_in) f32 points -> ((N,) sdf, (N, d_in) grads or None)."""
        pts = np.ascontiguousarray(pts, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != self.d_in:
            raise ValueError(f"expected (N, {self.d_in}) points, "
                             f"got {pts.shape}")
        n = len(pts)
        out = np.empty(n, np.float32)
        grads = np.empty((n, self.d_in), np.float32) if gradients else None
        rc = self._lib.sdfnet_evaluate(
            self._h, pts.ctypes.data_as(_FPTR), n,
            out.ctypes.data_as(_FPTR),
            grads.ctypes.data_as(_FPTR) if gradients else None,
            n_threads,
        )
        if rc != 0:
            raise RuntimeError(self._lib.sdfnet_last_error().decode())
        return out, grads

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        return self.evaluate(pts)[0]

    def close(self) -> None:
        if self._h:
            self._lib.sdfnet_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # __init__ may have raised before the handle existed
        if getattr(self, "_h", None):
            self.close()
