"""torch.profiler windows in one process: does a later window still hold
the card's events?

Each scenario runs in a process of its own (``--scenario NAME``) and opens
a sequence of profiler windows, each around one workload, and reads every
window: in "trace" windows (utils/profiling.trace, the Chrome trace it
writes) the kernel, copy and set events on the device and the runtime's
launch calls on the host; in "profile" windows (a bare
``torch.profiler.profile``, read through ``prof.events()`` as
chip_smoke.kernels_per_call reads it) the device events. A window whose
host launched kernels but whose device side holds none is "empty".

Workloads, at the flagship's widths (8x512, batch 16,384, bfloat16):

  * mm: 100 bf16 matrix products of 1024 x 1024;
  * epoch: 39 eager supervised steps (make_train_step,
    WeightedSmoothL2Loss), ~11,000 launches, as chip_smoke.py phase 4i (f)
    traces them;
  * igr: 10 eager labelled IGRLOSS steps through the fused kernels 8-9;
  * igr_call: one igr_fwd and one igr_bwd call (chip_smoke.kernels_per_call);
  * graph: 20 replays of a CUDA graph of 50 products.

Needs a card (builds csrc/fused_igr.cu):

    python3 tools/profiler_windows_study.py [--out FILE] [--scenarios a,b]
"""
import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SCENARIOS = {
    "trace_mm_x6": [("trace", "mm")] * 6,
    "pr12": [("trace", "epoch"), ("trace", "igr")] + [("profile", "igr_call")] * 3,
    "trace_epoch_then_mm_x4": [("trace", "epoch")] + [("trace", "mm")] * 4,
    "trace_igr_x6": [("trace", "igr")] * 6,
    "profile_igr_call_x6": [("profile", "igr_call")] * 6,
    "trace_mm_x2_then_profile_mm_x3": [("trace", "mm")] * 2 + [("profile", "mm")] * 3,
    "trace_graph_x4": [("trace", "graph")] * 4,
    "trace_epoch_x3": [("trace", "epoch")] * 3,
}


def workloads(device):
    from sdf_representation_tpu_torch.losses.losses import IGRLOSS, WeightedSmoothL2Loss
    from sdf_representation_tpu_torch.models import ImplicitNet
    from sdf_representation_tpu_torch.ops import fused_igr as fi
    from sdf_representation_tpu_torch.ops import fused_mlp as fm
    from sdf_representation_tpu_torch.training.trainer import make_train_step

    gen = torch.Generator().manual_seed(0)
    x = (torch.rand(39 * 16384, 3, generator=gen) * 2 - 1).to(device)
    r = x.norm(dim=1, keepdim=True)
    y = torch.cat([r - 0.85, x / r], dim=1)

    def net():
        return ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5,
                           generator=torch.Generator().manual_seed(0), device=device)

    sup_model, igr_model = net(), net()
    sup = make_train_step(sup_model, WeightedSmoothL2Loss(),
                          torch.optim.Adam(sup_model.parameters(), 1e-4), "bfloat16")
    igr = make_train_step(igr_model, IGRLOSS(), torch.optim.Adam(igr_model.parameters(), 1e-4),
                          "bfloat16")
    fused = fm.FusedNet(net(), torch.bfloat16)
    xs, a, c = x[:16384], y[:16384, 0] / 16384, y[:16384, 1:] / 16384
    m = torch.randn(1024, 1024, device=device, dtype=torch.bfloat16)

    def mm():
        for _ in range(100):
            m @ m

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(50):
            m @ m
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(50):
            m @ m

    return {
        "mm": mm,
        "epoch": lambda: [sup(x[i * 16384:(i + 1) * 16384], y[i * 16384:(i + 1) * 16384], 0)
                          for i in range(39)],
        "igr": lambda: [igr(x[i * 16384:(i + 1) * 16384], y[i * 16384:(i + 1) * 16384], 0)
                        for i in range(10)],
        "igr_call": lambda: (fi.fused_value_and_grad(fused, xs), fi.fused_param_grads(fused, xs, a, c)),
        "graph": lambda: [graph.replay() for _ in range(20)],
    }


def read_trace(log_dir):
    (path,) = pathlib.Path(log_dir).glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    launches = sum(1 for e in events if str(e.get("cat")).startswith("cuda_")
                   and any(k in e["name"] for k in ("LaunchKernel", "GraphLaunch")))
    device = sum(cats.get(k, 0) for k in ("kernel", "gpu_memcpy", "gpu_memset"))
    return {"kernels": cats.get("kernel", 0), "device_events": device, "host_launches": launches,
            "trace_bytes": path.stat().st_size}


def run_scenario(name):
    from torch.profiler import ProfilerActivity, profile

    from sdf_representation_tpu_torch import kernels
    from sdf_representation_tpu_torch.utils import profiling

    kernels.build_all(["fused_igr"])
    device = torch.device("cuda", 0)
    work = workloads(device)
    for fn in work.values():  # every workload once, unprofiled
        fn()
    torch.cuda.synchronize()
    rows = []
    root = pathlib.Path(tempfile.mkdtemp(prefix="profiler_windows_"))
    try:
        for i, (mode, what) in enumerate(SCENARIOS[name]):
            t0 = time.perf_counter()
            if mode == "trace":
                log_dir = root / f"w{i}"
                with profiling.trace(str(log_dir)):
                    work[what]()
                    torch.cuda.synchronize()
                row = read_trace(log_dir)
            else:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    work[what]()
                    torch.cuda.synchronize()
                device_events = [e for e in prof.events()
                                 if e.device_type == torch.autograd.DeviceType.CUDA]
                row = {"device_events": len(device_events),
                       "host_launches": sum(1 for e in prof.events()
                                            if "LaunchKernel" in e.name or "GraphLaunch" in e.name)}
            row.update(window=i, mode=mode, workload=what, seconds=time.perf_counter() - t0,
                       empty=row["device_events"] == 0 and row["host_launches"] > 0)
            rows.append(row)
            print(f"{name} window {i}: {json.dumps(row)}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("RESULT " + json.dumps(rows), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", default=None, help="run this scenario here (a child)")
    parser.add_argument("--scenarios", default=",".join(SCENARIOS))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: the study traces the card's events")
    if args.scenario:
        run_scenario(args.scenario)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    from sdf_representation_tpu_torch import kernels

    kernels.build_all(["fused_igr"])
    out = {"card": card, "torch": torch.__version__, "scenarios": {}}
    for name in args.scenarios.split(","):
        res = subprocess.run([sys.executable, __file__, "--scenario", name], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        print(res.stdout, end="", flush=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
        if res.returncode != 0 or not lines:
            print(f"{name}: exit {res.returncode}: {res.stderr[-3000:]}", flush=True)
            out["scenarios"][name] = {"error": res.stderr[-3000:]}
            continue
        rows = json.loads(lines[-1][len("RESULT "):])
        out["scenarios"][name] = rows
        print(f"{name}: empty windows {[r['window'] for r in rows if r['empty']]}", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
