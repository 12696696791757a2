"""The exact-SDF stream kernels (csrc/sdf_streams.cu) at chip_smoke.py
phase 3's shapes, in several CTA shapes, against their plain versions.

Builds csrc/sdf_streams.cu once per CTA shape, a shape being
PTSxTHREADS[xDIST_TRISxWIND_TRISxDIST_UNROLLxWIND_UNROLL]: the values of the
source's constants kPts, kThreads, kDistTris, kWindTris, kDistUnroll and
kWindUnroll in that order (points per thread, threads per CTA, triangles per
ring stage of each kernel, the unrolling of each kernel's triangle loop;
those left out keep the source's value), each in a copy of csrc/; prints each build's registers, local memory and
SASS instruction count per kernel, then on 262,144 mixed points (uniform,
on the surface, in a band) x the rescaled icosphere(5) (20,480 faces):
the dense schedule (blocks of 8,192, chunks of 1,024) and the culled one
(Morton blocks of 2,048, chunks of 512), both made by chip_smoke.py's own
functions (stream_inputs, culled_schedule), so they are phase 3's; each
kernel held against its plain version (d^2 rtol 1e-5 / atol 1e-7 with
winners equal but for f64-oracle ties, solid angles rtol 1e-4 / atol 1e-3),
timed with CUDA events, the culled one also with the CTAs in block order
(no launch_order). Needs a card:

    python3 tools/stream_study.py [--shapes 2x256,4x128,2x256x128x128x1x1] [--out FILE]
    python3 tools/stream_study.py --repo DIR   # another checkout's package, as built

With --repo the package of that checkout is imported and timed as it ships
(its own csrc and build); --shapes does not apply.
"""
import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--repo", default=None, help="import the package from this checkout")
parser.add_argument("--shapes", default="2x256", help="comma-separated shapes (see above)")
parser.add_argument("--reps", type=int, default=5)
parser.add_argument("--out", default=None)
args = parser.parse_args()
REPO = pathlib.Path(args.repo or pathlib.Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(REPO))
if not torch.cuda.is_available():
    sys.exit("no card: the study runs the CUDA kernels")

from sdf_representation_tpu_torch import kernels  # noqa: E402
from sdf_representation_tpu_torch.ops import sdf_exact as se  # noqa: E402
from sdf_representation_tpu_torch.ops import sdf_streams as ss  # noqa: E402

# this checkout's chip_smoke.py (also with --repo: its functions then build
# the inputs with the other checkout's package)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip().splitlines()[0]
print(f"card: {card}; package {REPO}", flush=True)
HERE = pathlib.Path(__file__).resolve().parents[1] / "build" / "stream_study"
HERE.mkdir(parents=True, exist_ok=True)
CUOBJDUMP = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def sass_counts(lib):
    """Per stream kernel: SASS instructions, registers, stack and local bytes."""
    sass = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    usage = subprocess.run([CUOBJDUMP, "-res-usage", str(lib)], capture_output=True, text=True,
                           check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"instructions": 0}
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            out[fn]["instructions"] += 1
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", usage):
        if m.group(1) in out:
            out[m.group(1)].update(registers=int(m.group(2)), stack=int(m.group(3)),
                                   local=int(m.group(5)))
    return {("dist_kernel" if "dist_kernel" in k else "wind_kernel"): v for k, v in out.items()
            if "dist_kernel" in k or "wind_kernel" in k}


CONSTANTS = ("kPts", "kThreads", "kDistTris", "kWindTris", "kDistUnroll", "kWindUnroll")


def build(shape):
    src = (kernels.CSRC / "sdf_streams.cu").read_text()
    for name, value in zip(CONSTANTS, shape.split("x")):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            raise RuntimeError(f"{name} is not a constant of sdf_streams.cu")
    d = HERE / f"csrc_{shape}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(kernels.CSRC, d)
    (d / "sdf_streams.cu").write_text(src)
    lib = HERE / f"libsdf_streams_{shape}.so"
    t0 = time.perf_counter()
    p = subprocess.run(["/usr/local/cuda/bin/nvcc", *kernels.nvcc_flags("sdf_streams"),
                        "-Xptxas=-v", "-o", str(lib), str(d / "sdf_streams.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc {shape}:\n{p.stdout}{p.stderr}")
    return shape, lib, time.perf_counter() - t0


def use(lib):
    kernels.load = lambda _n, p=lib: ctypes.CDLL(str(p))
    ss._lib.cache_clear()


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


mesh, pts = cs.stream_inputs(np.random.default_rng(cs.SEED))
cases = {}
# dense: chip_smoke phase 3 / 5's schedule
tables, _ = se._triangle_tables(mesh.vertices, mesh.faces, 1024)
P = torch.from_numpy(pts.reshape(-1, se.POINT_CHUNK, 3)).to(dev)
sb, sc_, _ = ss.stream_steps(np.ones((P.shape[0], tables["a"].shape[0]), bool), P.shape[0])
cases["dense"] = (P, (sb, sc_), (sb, sc_), tables, 1024, pts, mesh.faces)
# culled: check_sharded's schedule
_, Pc, faces, t512, kd, kw = cs.culled_schedule(dev, mesh, pts, 512, 2048)
db, dc, _ = ss.stream_steps(kd, Pc.shape[0])
wb, wc, _ = ss.stream_steps(kw, Pc.shape[0])
cases["culled"] = (Pc, (db, dc), (wb, wc), t512, 512, Pc.reshape(-1, 3).cpu().numpy(), faces)

plain = {}
for name, (Pt, ds, ws, tab, tc, flat, fc) in cases.items():
    plain[name] = (ss.dist_stream_plain(Pt, *ds, tab, tc), ss.wind_stream_plain(Pt, *ws, tab, tc))
torch.cuda.synchronize()


def held(name, d2, best, w):
    """Against plain at the chip limits; returns the readings."""
    Pt, ds, ws, tab, tc, flat, fc = cases[name]
    (pd2, pbest), pw = plain[name]
    fin = torch.isfinite(pd2)
    dd = (d2 - pd2)[fin].abs()
    over_d = (dd - (1e-7 + 1e-5 * pd2[fin].abs())).max().item()
    dw = (w - pw).abs()
    over_w = (dw - (1e-3 + 1e-4 * pw.abs())).max().item()
    gb, pb = best.flatten().cpu().numpy(), pbest.flatten().cpu().numpy()
    differ = np.nonzero(gb != pb)[0]
    n_rows = Pt.shape[0] * Pt.shape[1]
    differ = differ[differ < n_rows]
    ties = True
    if len(differ):
        q = flat[differ].astype(np.float64)
        t = mesh.vertices[fc]
        da = np.linalg.norm(q - se.closest_point_on_triangles(q, t[gb[differ]]), axis=1)
        db_ = np.linalg.norm(q - se.closest_point_on_triangles(q, t[pb[differ]]), axis=1)
        ties = bool(np.allclose(da, db_, rtol=1e-5, atol=1e-6))
    ok = over_d <= 0 and over_w <= 0 and ties and torch.equal(torch.isfinite(d2), fin)
    return {"ok": bool(ok), "max_d2_diff": dd.max().item(), "d2_over_limit": over_d,
            "winners_differing": int(len(differ)), "all_ties": ties,
            "max_omega_diff": dw.max().item(), "omega_over_limit": over_w}


def run_all(tag):
    res = {}
    for name, (Pt, ds, ws, tab, tc, flat, fc) in cases.items():
        d2, best = ss.dist_stream(Pt, *ds, tab, tc)
        w = ss.wind_stream(Pt, *ws, tab, tc)
        torch.cuda.synchronize()
        d2b, bestb = ss.dist_stream(Pt, *ds, tab, tc)
        wb_ = ss.wind_stream(Pt, *ws, tab, tc)
        row = held(name, d2, best, w)
        row["repeat_bit_equal"] = bool(torch.equal(d2, d2b) and torch.equal(best, bestb)
                                       and torch.equal(w, wb_))
        row["ok"] = row["ok"] and row["repeat_bit_equal"]
        pairs_d = sum(1 for b in ds[0] if b < Pt.shape[0]) * Pt.shape[1] * tc
        pairs_w = sum(1 for b in ws[0] if b < Pt.shape[0]) * Pt.shape[1] * tc
        row["dist_ms"] = timed(lambda: ss.dist_stream(Pt, *ds, tab, tc), args.reps)
        row["wind_ms"] = timed(lambda: ss.wind_stream(Pt, *ws, tab, tc), args.reps)
        row["dist_pairs"], row["wind_pairs"] = pairs_d, pairs_w
        if name == "culled" and hasattr(ss, "launch_order"):
            keep = ss.launch_order
            ss.launch_order = lambda offs: np.arange(len(offs) - 1, dtype=np.int32)
            row["dist_ms_block_order"] = timed(lambda: ss.dist_stream(Pt, *ds, tab, tc), args.reps)
            row["wind_ms_block_order"] = timed(lambda: ss.wind_stream(Pt, *ws, tab, tc), args.reps)
            ss.launch_order = keep
        print(f"{tag} {name}: " + json.dumps(row), flush=True)
        res[name] = row
    return res


report = {"card": card, "package": str(REPO), "shapes": {}}
if args.repo:
    report["build_s"] = kernels.build("sdf_streams", verbose=True)
    report["sass"] = sass_counts(kernels.library_path("sdf_streams"))
    print("sass", json.dumps(report["sass"]), flush=True)
    report["shapes"]["as built"] = run_all("as built")
else:
    shapes = args.shapes.split(",")
    with ThreadPoolExecutor(len(shapes)) as pool:
        built = list(pool.map(build, shapes))
    for shape, lib, secs in built:
        use(lib)
        layout = ss.kernel_layout()
        sass = sass_counts(lib)
        print(f"shape {shape}: built in {secs:.1f} s, layout {layout}, sass {json.dumps(sass)}",
              flush=True)
        report["shapes"][shape] = {"build_s": secs, "layout": layout, "sass": sass,
                                   **run_all(shape)}
if args.out:
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
ok = all(r["ok"] for s in report["shapes"].values() for k, r in s.items() if isinstance(r, dict)
         and "ok" in r)
print(json.dumps({"ok": ok}))
sys.exit(0 if ok else 1)
