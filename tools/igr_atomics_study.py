"""What the f32 eikonal backward's atomics cost in the routine the
split-TF32 one replaced: the SIMT igr_bwd of a parent checkout's
csrc/fused_igr.cu, built as it is and with every atomicAdd(p, v) made a
plain store *(p) = v (the same traffic with no read-modify-write; its
gradients are wrong), each timed on the card at 8x512, N = 16,384 through
that checkout's own wrapper, interleaved (as is, stores, stores, as is),
beside this checkout's igr_bwd on the same inputs. Each variant runs in a
process of its own, since both checkouts' packages share one name. Needs
a card and an unpacked parent checkout:

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/igr_atomics_study.py --parent build/parent [--out build/igr_atomics_study.json]
"""
import argparse
import json
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parents[1]
HERE = REPO / "build" / "igr_atomics_study"

# one timing in a child process: the package under `root`, 8x512 f32, CUDA events
CHILD = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from sdf_representation_tpu_torch import kernels
from sdf_representation_tpu_torch.models import ImplicitNet
from sdf_representation_tpu_torch.ops import fused_igr as fi
from sdf_representation_tpu_torch.ops import fused_mlp as fm
if sys.argv[2] == "build":
    kernels.build("fused_igr")
    sys.exit(0)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
model = ImplicitNet(hidden_dims=(512,) * 8, skip_in=(4,), beta=100.0, radius_init=0.5, generator=gen, device=dev)
n = 16384
x = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
a = (torch.randn(n, generator=gen) / n).to(dev)
c = (torch.randn(n, 3, generator=gen) / n).to(dev)
net = fm.FusedNet(model, torch.float32)
run = lambda: fi.fused_param_grads(net, x, a, c)
run()
torch.cuda.synchronize()
start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(10):
    run()
stop.record()
torch.cuda.synchronize()
print(json.dumps({"ms": start.elapsed_time(stop) / 10}))
'''


def plain_stores(src: str) -> str:
    """Every atomicAdd(p, v) of a source as *(p) = v."""
    out, i = [], 0
    while (j := src.find("atomicAdd(", i)) >= 0:
        out.append(src[i:j])
        k, depth, comma = j + len("atomicAdd("), 1, None
        while depth:
            ch = src[k]
            depth += ch == "("
            depth -= ch == ")"
            if ch == "," and depth == 1 and comma is None:
                comma = k
            k += 1
        out.append(f"*({src[j + len('atomicAdd('):comma].strip()}) = {src[comma + 1:k - 1].strip()}")
        i = k
    return "".join(out) + src[i:]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, help="an unpacked checkout with the SIMT routine")
    parser.add_argument("--out", default=str(REPO / "build" / "igr_atomics_study.json"))
    args = parser.parse_args()
    parent = pathlib.Path(args.parent).resolve()
    HERE.mkdir(parents=True, exist_ok=True)
    (HERE / "child.py").write_text(CHILD)
    roots = {"current": REPO}
    for variant in ("as_is", "plain_stores"):
        root = HERE / variant
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(parent / "sdf_representation_tpu_torch", root / "sdf_representation_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        if variant == "plain_stores":
            cu = root / "sdf_representation_tpu_torch" / "csrc" / "fused_igr.cu"
            src = cu.read_text()
            if "atomicAdd(" not in src:
                raise RuntimeError(f"{cu} has no atomicAdd: not the SIMT routine")
            cu.write_text(plain_stores(src))
        roots[variant] = root

    def child(root, what):
        p = subprocess.run([sys.executable, str(HERE / "child.py"), str(root), what], capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"{root} {what}: {p.stdout}{p.stderr}")
        return p.stdout

    with ThreadPoolExecutor(max_workers=3) as pool:  # the three builds at once
        list(pool.map(lambda r: child(r, "build"), roots.values()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    times = {name: [] for name in roots}
    for name in ("current", "as_is", "plain_stores", "plain_stores", "as_is", "current"):
        times[name].append(json.loads(child(roots[name], "time").strip().splitlines()[-1])["ms"])
        print(f"{name}: {times[name][-1]:.4f} ms", flush=True)
    row = {"card": card, "ms": {k: min(v) for k, v in times.items()}, "all_ms": times}
    row["atomics_share_of_simt"] = 1 - row["ms"]["plain_stores"] / row["ms"]["as_is"]
    print(json.dumps(row), flush=True)
    pathlib.Path(args.out).write_text(json.dumps(row, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
