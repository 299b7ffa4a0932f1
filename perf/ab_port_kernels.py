"""A/B on one card: another commit's ``topo_sweep`` and ``lane_finish``
sources against this tree's, on the same inputs, in the order reference,
change, change, reference (twice), each a CUDA-event mean over 30 calls.

    git show <commit>:stl_fusion_tpu_torch/csrc/topo_sweep.cu > REF/topo_sweep.cu
    git show <commit>:stl_fusion_tpu_torch/csrc/lane_finish.cu > REF/lane_finish.cu
    python perf/ab_port_kernels.py REF        # on the card; REF inside the repo

``topo_sweep``: the ``topo_10m`` sweep (``bench.py``'s 10M-node graph,
W = 16, k = 4, 512 packed waves). ``lane_finish``: W = 16 over 11,272,193
rows of random lane bits (70% zero rows), a random injective perm over
10M real rows, 1/8 of the dense bits pre-invalid. Both outputs must be
equal. Prints one JSON line with the card's name and power limit."""
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from stl_fusion_tpu_torch.bench import build_topo_leg  # noqa: E402
from stl_fusion_tpu_torch.ops import _build, topo_wave as tpw  # noqa: E402
from stl_fusion_tpu_torch.ops.bitops import pack_bits  # noqa: E402

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


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

# ---- lane_finish: call each library's own entry
# a reference from before any-W (ROADMAP C.1) has no word count and no launches out
ref_lane = f"{REF}/lane_finish.cu"
old_entry = "void* launched" not in open(ref_lane).read()
lf_parent = build("lane_parent", ref_lane, "lane_finish_launch",
                  [P] * 7 + ([LL, I, P] if old_entry else [LL, I, LL, P, P]))[1]
lf_change = build("lane_change", "stl_fusion_tpu_torch/csrc/lane_finish.cu", "lane_finish_launch",
                  [P] * 7 + [LL, I, LL, P, P])[1]
rng = np.random.default_rng(3)
n_rows, n_real, W = 11_272_193, 10_000_000, 16
n_cap = 1 << 24
bits16 = torch.randint(-(2**31), 2**31, (n_rows, W), dtype=torch.int32, device="cuda")
bits16[torch.rand(n_rows, device="cuda") < 0.7] = 0
perm_np = np.full(n_rows, n_cap, np.int32)
real_rows = rng.permutation(n_rows)[:n_real]
perm_np[real_rows] = rng.permutation(n_real).astype(np.int32)
is_real_np = np.zeros(n_rows, bool)
is_real_np[real_rows] = True
perm, is_real = torch.from_numpy(perm_np).cuda(), torch.from_numpy(is_real_np).cuda()
g0 = pack_bits(torch.rand(n_cap + 1, device="cuda") < 0.125)


def lane(tag):
    g = g0.clone()
    lc = torch.zeros(32 * W, dtype=torch.int32, device="cuda")
    uc = torch.zeros(1, dtype=torch.int32, device="cuda")
    nw = torch.zeros_like(g)
    made = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream

    def run(e=None):
        torch._foreach_copy_([g], [g0])
        lc.zero_(), uc.zero_(), nw.zero_()
        if e:
            e[0].record()
        args = [bits16.data_ptr(), is_real.data_ptr(), perm.data_ptr(), g.data_ptr(),
                nw.data_ptr(), lc.data_ptr(), uc.data_ptr(), n_rows, W]
        if tag == "parent" and old_entry:
            rc = lf_parent(*args, stream)
        elif tag == "parent":
            rc = lf_parent(*args, g.shape[0], ctypes.addressof(made), stream)
        else:
            rc = lf_change(*args, g.shape[0], ctypes.addressof(made), stream)
        assert rc == 0
        if e:
            e[1].record()
        return lc, uc, nw, g
    ms, o = timed(run)
    return ms, [t.clone() for t in o]


out = {"parent": [], "change": []}
outs = {}
for tag in ["parent", "change", "change", "parent"] * 2:
    ms, outs[tag] = lane(tag)
    out[tag].append(ms)
assert all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["change"]))
res["lane_finish_w16_ms"] = out
print(json.dumps(res), flush=True)
