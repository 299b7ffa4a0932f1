"""A/B on one card: another commit's ``topo_sweep`` source against this
tree's, on the same inputs, in the order reference, change, change,
reference (twice), each a CUDA-event mean over 30 calls.

    git show <commit>:stl_fusion_tpu_torch/csrc/topo_sweep.cu > REF/topo_sweep.cu
    python perf/ab_port_kernels.py REF        # on the card; REF inside the repo

``topo_sweep``: the ``topo_10m`` sweep (``bench.py``'s 10M-node graph,
W = 16, k = 4, 512 packed waves). Both outputs must be equal. Prints one
JSON line with the card's name and power limit. ``lane_finish`` sources
are compared by ``perf/ab_lane_finish.py``."""
import ctypes
import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
from stl_fusion_tpu_torch.bench import build_topo_leg  # noqa: E402
from stl_fusion_tpu_torch.ops import _build, topo_wave as tpw  # noqa: E402


def build(tag, src, entry, argtypes):
    out = str(_build.BUILD_DIR / f"ab_{tag}.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    print(tag, _build._ptxas_stats(r.stdout + r.stderr), flush=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(out)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, fn


def timed(fn, reps=30):
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    torch.cuda.synchronize()
    tot = 0.0
    for _ in range(reps):
        out = fn(e)
        e[1].synchronize()
        tot += e[0].elapsed_time(e[1])
    return tot / reps, out


REF = sys.argv[1]
res = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()}
# ---- topo_sweep: swap the library the wrapper loads
ts = {tag: build(f"topo_{tag}", src, "topo_sweep_launch",
                 _build.KERNELS["topo_sweep"][1]["topo_sweep_launch"])[0]
      for tag, src in (("parent", f"{REF}/topo_sweep.cu"),
                       ("change", "stl_fusion_tpu_torch/csrc/topo_sweep.cu"))}
leg = build_topo_leg(device="cuda")
graph, ga, seeds, st = leg["graph"], leg["wave32"].garrays, leg["seed_bits"][-1], leg["state"]


def sweep(tag):
    def run(e=None):
        st.invalid_bits.zero_()
        if e:
            e[0].record()
        tpw.topo_sweep(graph.level_starts, ga, seeds, st)
        if e:
            e[1].record()
        return st.invalid_bits
    _build._libs["topo_sweep"] = ts[tag]
    ms, bits = timed(run)
    return ms, bits.clone()


out = {"parent": [], "change": []}
bits = {}
for tag in ["parent", "change", "change", "parent"] * 2:
    ms, bits[tag] = sweep(tag)
    out[tag].append(ms)
assert torch.equal(bits["parent"], bits["change"])
res["topo_sweep_ms"] = out
del bits

print(json.dumps(res), flush=True)
