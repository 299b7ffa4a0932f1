"""A/B on one card: ``packed_pull`` sources that share the tree's C entry
(``packed_pull_launch`` with the fired summaries), on the levels the main
path runs: every level of the first ``packed_10m`` batch (``bench.py``'s
10M-node power-law graph, W = 16, k = 8, 512 waves of 100,000 seeds,
from level 0 with every row lit to the tail) and level 0 of the pull leg
(W = 1, 32 waves). Every source must give the same invalid words, counts,
summary and next on the rows that fire; then each level is timed in turns
(the sources in order, then in reverse), each a CUDA-event mean over 30
calls less the restore of the rows the level changes. The last line sums
the batch's levels for each source.

    python perf/ab_packed_pull.py stl_fusion_tpu_torch/csrc/packed_pull.cu OTHER.cu ...

on the card (sources inside the repo). Prints each source's registers and
spills (ptxas), the card's name and power limit, and one JSON line a level:
{source: ms}."""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from stl_fusion_tpu_torch import bench  # noqa: E402
from stl_fusion_tpu_torch.ops import _build  # noqa: E402
from stl_fusion_tpu_torch.ops import packed_pull as ppp  # noqa: E402
from stl_fusion_tpu_torch.ops.bitops import unpack_bits  # noqa: E402


def build(sources):
    """Each source compiled with the port's flags, all at once: {label: CDLL}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        label = f"{i}:{os.path.basename(src)}"
        out = str(_build.BUILD_DIR / f"ab_packed_pull_{i}.so")
        procs[label] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out)
    libs = {}
    for label, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        print(label, "registers", re.findall(r"Used (\d+) registers", text),
              "spill stores", re.findall(r"(\d+) bytes spill stores", text), flush=True)
        libs[label] = ctypes.CDLL(out)
        fn = libs[label].packed_pull_launch
        fn.argtypes = _build.KERNELS["packed_pull"][1]["packed_pull_launch"]
        fn.restype = ctypes.c_int
    return libs


def levels(device):
    """(name, tables, node_epoch, (frontier, invalid before, summary in),
    null row) of the levels timed."""
    n = 10_000_000
    leg = bench.build_sharded_leg(n, seeds_per_wave=100_000, packed=True, words=16,
                                  device=device)
    pleg = bench.build_pull_leg(n, seeds_per_wave=100_000, n_waves=32, device=device)
    pg = leg["graph"]
    tables = (pg.in_src, pg.edge_epoch, pg.is_real)
    seeds = leg["seeds_dev"][0]
    lv = cs.pull_levels(tables, seeds, pg.node_epoch, torch.zeros_like(pg.invalid),
                        keep=set(range(64)))
    ga, n_tot = pleg["wave32"].garrays, pleg["graph"].n_tot
    ptables = (ga.in_src, ga.edge_epoch, ga.is_real)
    plv = cs.pull_levels(ptables, pleg["seed_bits"][0].view(-1, 1), pleg["state"].node_epoch,
                         torch.zeros(n_tot + 1, 1, dtype=torch.int32, device=device), n_tot)
    return [*((f"level {level}", tables, pg.node_epoch, lv["kept"][level], -1)
              for level in range(len(lv["lit"]))),
            ("pull leg level 0", ptables, pleg["state"].node_epoch, plv["first"], n_tot)]


def main(sources):
    device = torch.device("cuda")
    libs = build(sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    batch = {label: 0.0 for label in libs}
    for name, (in_src, edge_epoch, is_real), node_epoch, inputs, null_row in levels(device):
        frontier, inv0, summary = inputs
        rows, w = inv0.shape
        runs, results = {}, {}
        for label, lib in libs.items():
            inv, nxt = inv0.clone(), torch.zeros_like(inv0)
            counts = torch.zeros(w, dtype=torch.int32, device=device)
            flag = torch.zeros(1, dtype=torch.int32, device=device)
            s_out = torch.zeros_like(summary)

            def run(lib=lib, inv=inv, nxt=nxt, counts=counts, flag=flag, s_out=s_out):
                _build._libs["packed_pull"] = lib
                ppp.packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv,
                                counts, flag_out=flag, null_row=null_row, summary_in=summary,
                                summary_out=s_out)
            run()
            fired = unpack_bits(s_out, rows)
            runs[label] = (run, inv, counts, flag)
            results[label] = [inv.clone(), torch.where(fired[:, None], nxt, 0), counts.clone(),
                              s_out.clone()]
        first = next(iter(results.values()))
        for label, got in results.items():
            if not all(torch.equal(a, b) for a, b in zip(got, first)):
                raise AssertionError(f"{name}: {label} differs from the first source")
        idx = torch.nonzero(unpack_bits(first[3], rows)).flatten()
        rows0 = inv0[idx]

        def calls(label):
            run, inv, counts, flag = runs[label]

            def restore():
                inv.index_copy_(0, idx, rows0)
                torch._foreach_zero_([counts, flag])

            def call():
                restore()
                run()
            return call, restore
        restore_ms = cs.time_ms(calls(next(iter(libs)))[1], device)
        laps = {label: [] for label in libs}
        for label in [*libs, *reversed(list(libs))]:
            laps[label].append(cs.time_ms(calls(label)[0], device) - restore_ms)
        ms = {label: sum(v) / len(v) for label, v in laps.items()}
        if name.startswith("level"):
            for label in libs:
                batch[label] += ms[label]
        print(json.dumps({"level": name, "lit_rows": int(idx.numel()), "restore_ms": restore_ms,
                          "ms": ms}), flush=True)
    print(json.dumps({"packed_10m batch, levels summed": batch}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
