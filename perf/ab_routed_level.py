"""A/B on one card: ``routed_level`` sources on the levels the routed mesh
path runs. The graph is ``perf/mesh_path.py``'s static leg at ``--nodes``
(10M by default; 80M is ``chip_smoke.py``'s ``mesh_80m``):
``power_law_dag(n, 3, seed=7)``, 4 members, 256 shards on 8 logical shards.
For each lookup (``a2a``, ``gather``, ``hier`` with 2 hosts of 4) it is built,
wave 0 of ``mesh_path``'s seeds (100,000, seed 123) runs once, and the
widest level's input is taken as ``chip_smoke.routed_capture`` takes it; the
seed step is wave 0's seeds over a clear state. Every source must give what
the tree's wrapper gives (invalid, next and counts, exactly); then each
launch is timed in turns (the sources in order, then in reverse), a
CUDA-event mean over 20 calls less the restore.

    python perf/ab_routed_level.py [--nodes N] [--lookups a2a,gather,hier] \\
        SRC.cu[:-DNAME=VALUE,...] ...

on the card, sources inside the repo (a build with ``-DROUTED_LEVEL_SKIP``,
the source's timing diagnostics, is timed but not held to the tree's
results): the tree's C entries (one struct of
64-bit arguments) or PR 15's (``routed_level_launch`` with 27 arguments,
``git show b04c47a:stl_fusion_tpu_torch/csrc/routed_level.cu``). Prints each
build's registers and spills (ptxas), the card's name and power limit, and
one JSON line a launch: {label: [ms in order, ms in reverse]}."""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap  # noqa: E402
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag  # noqa: E402
from stl_fusion_tpu_torch.mesh_path import STATIC  # noqa: E402
from stl_fusion_tpu_torch.ops import _build  # noqa: E402
from stl_fusion_tpu_torch.ops import routed_wave as rw  # noqa: E402
from stl_fusion_tpu_torch.parallel import RoutedShardedGraph, graph_mesh  # noqa: E402

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: PR 15's C entries: every argument on its own
OLD_ENTRIES = {
    "routed_level_launch": [_P, _LL] + [_P] * 14 + [_LL, _LL] + [_I] * 8 + [_P],
    "routed_seed_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
}
NEW_ENTRIES = {name: [ctypes.c_char_p, _P] for name in OLD_ENTRIES}


def build(specs):
    """Each ``SRC[:flags]`` compiled with the port's flags and its own, all
    at once: {label: (level launcher, seed launcher)}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, spec in enumerate(specs):
        src, _, flags = spec.partition(":")
        label = f"{i}:{os.path.basename(src)}" + (f"[{flags}]" if flags else "")
        out = str(_build.BUILD_DIR / f"ab_routed_level_{i}.so")
        old = "routed_level_launch(const void* x" in open(src).read()
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *[f for f in flags.split(",") if f],
               "-o", out, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out, old)
    launchers = {}
    for label, (proc, out, old) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        print(label, "registers", re.findall(r"Used (\d+) registers", text),
              "spill stores", re.findall(r"(\d+) bytes spill stores", text), flush=True)
        lib = ctypes.CDLL(out)
        for name, argtypes in (OLD_ENTRIES if old else NEW_ENTRIES).items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        launchers[label] = (_old_level if old else _new_level, _old_seed if old else _new_seed,
                            lib, "ROUTED_LEVEL_SKIP" in label)
    return launchers


def _stream():
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _new_level(lib, x, stride, cross, L, nepoch, inv, nxt, out):
    args = rw._layout_args(L, inv.get_device()) + rw._CALL_ARGS.pack(
        x.data_ptr(), stride, (x if cross is None else cross).data_ptr(), nepoch.data_ptr(),
        inv.data_ptr(), nxt.data_ptr(), 0, out.data_ptr(), 0, 0)
    _check(lib.routed_level_launch(args, _stream()), "routed_level_launch")


def _old_level(lib, x, stride, cross, L, nepoch, inv, nxt, out):
    _check(lib.routed_level_launch(
        x.data_ptr(), stride, (x if cross is None else cross).data_ptr(), L.eprod.data_ptr(),
        L.ebslot.data_ptr(), L.ebit.data_ptr(), L.edst.data_ptr(), L.elsrc.data_ptr(),
        L.eepoch.data_ptr(), L.n_edges.data_ptr(), nepoch.data_ptr(), inv.data_ptr(),
        nxt.data_ptr(), 0, out.data_ptr(), 0, L.e_cap, L.max_edges, L.n_local, L.n_dev, L.mode,
        L.icap, L.hcap, L.dph, L.n_hosts, 0, _stream()), "routed_level_launch")


def _new_seed(lib, seeds, inv, out, n_dev, w_local):
    args = rw._SEED_ARGS.pack(seeds.data_ptr(), inv.data_ptr(), w_local, n_dev, out.data_ptr(),
                              0, 0, 0)
    _check(lib.routed_seed_launch(args, _stream()), "routed_seed_launch")


def _old_seed(lib, seeds, inv, out, n_dev, w_local):
    _check(lib.routed_seed_launch(seeds.data_ptr(), inv.data_ptr(), w_local, n_dev,
                                  out.data_ptr(), 0, 0, 0, _stream()), "routed_seed_launch")


def in_turns(device, calls: dict, restore) -> dict:
    """{label: [ms, ms]}: each call timed in order, then in reverse, less
    the restore's time."""
    res = {label: [] for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            res[label].append(cs.time_ms(calls[label], device, reps=20)
                              - cs.time_ms(restore, device, reps=20))
    return res


def ab_level(device, g, cap, launchers, what):
    """The captured level through every source against the tree's wrapper."""
    x, stride, cross, inv0 = cap["x"], cap["stride"], cap["cross"], cap["inv"]
    w, L = g._wave, g._wave.layout
    inv, nxt = inv0.clone(), torch.zeros_like(cap["front"])
    out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=device)

    def restore():
        inv.copy_(inv0)
        nxt.zero_()
        out.zero_()

    restore()
    rw.routed_level(x, stride, cross, L, w.nepoch, inv, nxt, out)
    want = (inv.clone(), nxt.clone(), out.clone())
    calls = {}
    for label, (level, _seed, lib, diagnostic) in launchers.items():
        def call(level=level, lib=lib):
            restore()
            level(lib, x, stride, cross, L, w.nepoch, inv, nxt, out)
        call()
        torch.cuda.synchronize()
        if not diagnostic and not all(torch.equal(a, b) for a, b in zip((inv, nxt, out), want)):
            raise AssertionError(f"{what}: {label} differs from the tree's kernel")
        calls[label] = call
    return {"what": what, "newly": int(want[2][g.n_dev]), "level": cap["level"],
            "ms": in_turns(device, calls, restore)}


def ab_seed(device, g, seed_ids, launchers, what):
    """Wave 0's seed step over a clear state through every source."""
    seeds = g._words_of_rows(g.perm[np.asarray(seed_ids, np.int64)])
    inv = torch.zeros_like(g.g_invalid)
    out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=device)

    def restore():
        inv.zero_()
        out.zero_()

    restore()
    rw.routed_seed(seeds, inv, out, g.n_dev, g.w_local)
    want = (inv.clone(), out.clone())
    calls = {}
    for label, (_level, seed, lib, _diagnostic) in launchers.items():
        def call(seed=seed, lib=lib):
            restore()
            seed(lib, seeds, inv, out, g.n_dev, g.w_local)
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((inv, out), want)):
            raise AssertionError(f"{what}: {label} differs from the tree's kernel")
        calls[label] = call
    return {"what": what, "fresh": int(want[1][g.n_dev]), "ms": in_turns(device, calls, restore)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=10_000_000)
    ap.add_argument("--lookups", default="a2a,gather,hier")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    launchers = build(args.sources)
    n = args.nodes
    src, dst = power_law_dag(n, avg_degree=3.0, seed=7)
    smap = ShardMap.initial([f"m{i}" for i in range(STATIC["members"])], n_shards=STATIC["shards"])
    seed_ids = np.random.default_rng(123).choice(n, size=STATIC["seeds"], replace=False)
    for lookup in args.lookups.split(","):
        dph = cs.MESH_HIER_DPH if lookup == "hier" else None
        g = RoutedShardedGraph(src, dst, n, DevicePlacement.build(smap, 8, n, devices_per_host=dph),
                               mesh=graph_mesh(devices=[device] * 8), exchange=lookup)
        g.run_wave_collect(seed_ids.tolist())
        cap = cs.routed_capture(g, seed_ids, cs.widest)
        print(json.dumps(ab_level(device, g, cap, launchers,
                                  f"{lookup} widest level, {n} nodes")), flush=True)
        if lookup == "a2a":
            print(json.dumps(ab_seed(device, g, seed_ids, launchers,
                                     f"seed step, {n} nodes")), flush=True)
        del g, cap
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
