"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

A ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the checkout
(the hash covers the source, every ``csrc`` header it includes, and all its
flags, so an edited source or header or a changed flag is rebuilt). Nothing
is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# -split-compile=0: nvcc runs its optimiser over a source's kernels on every
# core of the machine (one nvcc per source is started for all at once), which
# more than halves the build of fused_igr.cu and fused_mlp.cu, the longest,
# with no spills (chip_smoke.py's phase 2 prints the build times and ptxas's
# report, and checks every entry's SASS)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
)

# flags of one source only. sdf_streams: no contraction of a*b+c into FMA by
# the compiler, so every FMA is one the source writes (__fmaf_rn) and the
# winding rounds its numerator and denominator where the plain version does
# (see the note at the top of csrc/sdf_streams.cu)
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"sdf_streams": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> Iterable[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` file it includes with quotes,
    directly or through another, each once, in the order first reached."""
    seen, order, todo = set(), [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        order.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return order


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False, reports: Optional[Dict[str, str]] = None) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    wall seconds nvcc took (0.0 when there was nothing to do). ``verbose``
    adds ``-Xptxas=-v`` and prints nvcc's report (registers, shared memory,
    spills, ptxas's performance notes); ``reports[name]`` receives it too."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(name), *(["-Xptxas=-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(f"[nvcc {name}.cu]\n{proc.stdout}{proc.stderr}", flush=True)
    if reports is not None:
        reports[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return time.perf_counter() - t0


_SERIALISED = re.compile(r"wgmma\.mma_async instructions are serialized .*?function '(\S+)'")


def serialised_wgmma(report: str) -> List[str]:
    """The kernels whose wgmma ptxas serialised, by its report (the notes
    C7514, C7511: a pipeline it could not prove safe or give registers),
    each once, sorted."""
    return sorted(set(_SERIALISED.findall(report)))


def build_all(names: Iterable[str], verbose: bool = False,
              reports: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """Build several sources at once, one nvcc process each, all started
    together; returns the wall seconds per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(lambda n: build(n, verbose=verbose, reports=reports), names)))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built now if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
