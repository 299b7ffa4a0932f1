"""A/B on one card: ``lane_finish`` sources on the lane bursts' epilogue
inputs. The graph is ``chip_smoke.py``'s ``power_law_10m`` at ``--nodes``
(10M by default: ``power_law_dag(n, 3, seed=7)``, 1 % of nodes epoch-bumped)
with its topo mirror (``build_topo_mirror``, k = 6); the bits are one
512-group lane burst over it (``churn_10m``'s last groups: 8 distinct ids a
group from ``default_rng(13)``) through the lane gate and one sweep pass, from
a cleared state (W = 16, the row map ``perm_clipped``). ``--shapes`` picks:

- ``10m``: those bits, cleared dense words;
- ``w64``: the same bits four times over (W = 64: column chunks + commit);
- ``mesh``: the same groups as one gated mesh lane burst
  (``PackedShardedGraph(slack=2)`` on 8 logical shards, ``run_pull_wave``)
  from cleared blocked words: the identity map (the tree's sources take no
  map there; a source whose entry needs one gets ``arange(rows)``).

Every source whose build is not a split (``-DLANE_FINISH_SPLIT=1..3``, the
source's timing diagnostic) must give what ``lane_finish_plain`` gives from
the cleared words and from words with 1/8 of nodes invalid (lane counts,
union count, mask and dense words, exactly: a source that differs is listed
under ``wrong``, not timed, and the script exits 1); then each launch is timed in
turns (the sources in order, then in reverse), a CUDA-event mean over 20
calls less the restore (which puts the dense words back and zeroes the
outputs). ``--wrappers`` also times the tree's wrapper (``lane_finish``, on
the tree's build) and the parent's (three ``torch.zeros``, a library and
entry lookup and the launch, on the parent's source when one is given).

    python perf/ab_lane_finish.py [--nodes N] [--shapes 10m,w64,mesh] \\
        [--wrappers] SRC.cu[:-DNAME=VALUE,...] ...

on the card, sources inside the repo: the tree's C entry (11 arguments:
one counts buffer, a null row map for the identity) or the parent's
(``lane_finish_launch`` with 12 arguments, ``git show
8dd1da3:stl_fusion_tpu_torch/csrc/lane_finish.cu`` written into a directory
that ``.gitignore`` lists). Prints each build's registers and spills
(ptxas), the card's name and power limit, and one JSON line a shape:
{label: [ms in order, ms in reverse]}."""
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
from stl_fusion_tpu_torch.graph import DeviceGraph  # noqa: E402
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag  # noqa: E402
from stl_fusion_tpu_torch.ops import _build  # noqa: E402
from stl_fusion_tpu_torch.ops import topo_wave as tpw  # noqa: E402
from stl_fusion_tpu_torch.ops.bitops import pack_bits  # noqa: E402
from stl_fusion_tpu_torch.ops.packed_pull import run_pull_wave  # noqa: E402
from stl_fusion_tpu_torch.ops.pull_wave import pack_lane_matrix  # noqa: E402
from stl_fusion_tpu_torch.parallel import PackedShardedGraph, graph_mesh  # noqa: E402
from stl_fusion_tpu_torch.parallel.packed_wave import _gated_inputs  # noqa: E402

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: the parent's entry: lane counts and union count apart, the row map needed
OLD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _LL, _P, _P]
NEW_ARGS = [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _P, _P]


def build(specs):
    """Each ``SRC[:flags]`` compiled with the port's flags and its own, all
    at once: {label: (lib, old entry?, split build?)}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, spec in enumerate(specs):
        src, _, flags = spec.partition(":")
        label = f"{i}:{os.path.basename(src)}" + (f"[{flags}]" if flags else "")
        out = str(_build.BUILD_DIR / f"ab_lane_finish_{i}.so")
        old = "void* lane_counts, void* union_count" in open(src).read()
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
        lib.lane_finish_launch.argtypes = OLD_ARGS if old else NEW_ARGS
        lib.lane_finish_launch.restype = ctypes.c_int
        launchers[label] = (lib, old, "LANE_FINISH_SPLIT" in label)
    return launchers


def _stream():
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def launch(lib, old, bits, is_real, perm, g_inv, newly, counts, W):
    """One call of a source's entry; ``counts`` int32[32 W + 1] (lane
    counts, union count) and ``newly`` zeroed by the caller for the parent's
    entry (the tree's zeroes its own)."""
    made = ctypes.c_int(0)
    n, nw = bits.shape[0], g_inv.shape[0]
    if old:
        err = lib.lane_finish_launch(bits.data_ptr(), is_real.data_ptr(), perm.data_ptr(),
                                     g_inv.data_ptr(), newly.data_ptr(), counts.data_ptr(),
                                     counts.data_ptr() + 4 * 32 * W, n, W, nw,
                                     ctypes.addressof(made), _stream())
    else:
        err = lib.lane_finish_launch(bits.data_ptr(), is_real.data_ptr(),
                                     None if perm is None else perm.data_ptr(),
                                     g_inv.data_ptr(), newly.data_ptr(), counts.data_ptr(), n, W,
                                     nw, ctypes.addressof(made), _stream())
    if err:
        raise RuntimeError(f"lane_finish_launch failed with CUDA error {err}")
    return made.value


def in_turns(device, calls: dict, restore) -> dict:
    """{label: [ms, ms]}: each call timed in order, then in reverse, less
    the restore's time."""
    res = {label: [] for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            res[label].append(cs.time_ms(calls[label], device, reps=20)
                              - cs.time_ms(restore, device, reps=20))
    return res


def ab_shape(device, what, bits, is_real, perm, ident, g0, launchers, wrappers=False):
    """Every source on one input against the plain version, then timed in
    turns. ``perm`` is the row map; ``ident`` says the tree's sources take
    none (the identity form)."""
    W = bits.shape[1]
    some = pack_bits(torch.from_numpy(np.random.default_rng(1).random(32 * g0.shape[0])
                                      < 0.125).to(device))
    wants = {}
    for name, w0 in (("cleared", g0), ("1/8 invalid", some)):
        gp = w0.clone()
        lc, uc, nm = tpw.lane_finish_plain(bits, is_real, perm, gp)
        wants[name] = (w0, torch.cat([lc, uc.view(1)]), nm, gp)
    g_inv, newly = g0.clone(), torch.empty_like(g0)
    counts = torch.empty(32 * W + 1, dtype=torch.int32, device=device)

    def restore():
        torch._foreach_copy_([g_inv], [g0])
        newly.zero_()
        counts.zero_()

    calls, launches, wrong = {}, {}, []
    for label, (lib, old, split) in launchers.items():
        m = perm if (old or not ident) else None
        if not split:
            for name, (w0, want_counts, want_newly, want_g) in wants.items():
                g_inv.copy_(w0)
                newly.zero_()
                counts.zero_()
                launches[label] = launch(lib, old, bits, is_real, m, g_inv, newly, counts, W)
                torch.cuda.synchronize()
                diff = [k for k, a, b in (("lane counts", counts[:-1], want_counts[:-1]),
                                          ("union count", counts[-1:], want_counts[-1:]),
                                          ("mask", newly, want_newly), ("words", g_inv, want_g))
                        if not torch.equal(a, b)]
                if diff:
                    wrong.append(f"{label} ({name}): {diff}")
            if any(w.startswith(label + " ") for w in wrong):
                continue  # not timed

        def call(lib=lib, old=old, m=m):
            restore()
            launch(lib, old, bits, is_real, m, g_inv, newly, counts, W)
        calls[label] = call
    if wrappers:
        def tree_wrapper():
            restore()
            tpw.lane_finish(bits, is_real, None if ident else perm, g_inv)
        calls["wrapper: tree (lane_finish)"] = tree_wrapper
        parent = next((lib for lib, old, split in launchers.values() if old and not split), None)
        if parent is not None:
            def parent_wrapper(lib=parent):
                """The parent's wrapper on its kernel: three torch.zeros, the
                library and entry looked up (``_build.launch``), a launch."""
                restore()
                lc = torch.zeros(32 * W, dtype=torch.int32, device=device)
                uc = torch.zeros(1, dtype=torch.int32, device=device)
                nm = torch.zeros_like(g_inv)
                made = ctypes.c_int(0)
                stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
                err = lib.lane_finish_launch(
                    bits.data_ptr(), is_real.data_ptr(), perm.data_ptr(), g_inv.data_ptr(),
                    nm.data_ptr(), lc.data_ptr(), uc.data_ptr(), bits.shape[0], W,
                    g_inv.shape[0], ctypes.addressof(made), stream)
                if err:
                    raise RuntimeError(f"lane_finish_launch failed with CUDA error {err}")
            calls["wrapper: parent (zeros, lookup, launch)"] = parent_wrapper
    union = int(wants["cleared"][1][32 * W])
    return {"what": what, "rows": bits.shape[0], "W": W, "real": int(is_real.sum()),
            "dense_words": g0.shape[0], "union_rows": union, "identity": ident,
            "launches_per_call": launches, "wrong": wrong,
            "ms": in_turns(device, calls, restore)}


def topo_inputs(device, n):
    """(final bits int32[rows, 16], is_real, perm_clipped, cleared words,
    groups): the lane burst over ``power_law_10m``'s mirror."""
    src, dst = power_law_dag(n, avg_degree=3, seed=cs.GRAPH_SEED)
    rng = np.random.default_rng(cs.GRAPH_SEED)
    g = DeviceGraph(node_capacity=n, edge_capacity=len(src), device=device)
    g.add_nodes(n)
    g.add_edges(src, dst)
    g.bump_epochs(rng.choice(n, n // 100, replace=False))
    m = g.build_topo_mirror()
    mga, n_tot, lstarts = m["garrays"], m["n_tot"], m["level_starts"]
    grng = np.random.default_rng(7 + cs.CHURN_ROUNDS)
    groups = []
    while len(groups) < cs.LANE_GROUPS:
        ids = np.unique(grng.integers(0, n, size=cs.LANE_SEEDS))
        if ids.size == cs.LANE_SEEDS:
            groups.append(ids)
    mat, lw = pack_lane_matrix([x.tolist() for x in groups], pad_id=n_tot,
                               n_valid=m["n_nodes"], id_map=m["inv_perm"])
    g_inv = torch.zeros_like(g.device_arrays().invalid)
    node_epoch, lseeds = tpw.topo_mirror_gate_lanes_step(n_tot, lw)(
        mga.is_real, m["node_epoch0"], m["perm_clipped"], g_inv, torch.from_numpy(mat).to(device))
    st = tpw.TopoState(node_epoch, torch.zeros_like(lseeds))
    tpw.topo_sweep(lstarts, mga, lseeds, st, 0)
    return (st.invalid_bits, mga.is_real.clone(), m["perm_clipped"].clone(), g_inv, src, dst,
            groups)


def mesh_inputs(device, n, src, dst, groups):
    """(final bits, is_real, arange(rows), cleared blocked words) of the
    same groups as one gated mesh lane burst."""
    pg = PackedShardedGraph(src, dst, n, mesh=graph_mesh(8, device=device), slack=2)
    blocked = pg.put_blocked()
    mat, words = pack_lane_matrix([x.tolist() for x in groups], pad_id=pg.n_global,
                                  n_valid=pg.n_nodes)
    seeds, node_epoch = _gated_inputs(pg, torch.from_numpy(mat).to(device), blocked, words)
    inv = torch.zeros_like(seeds)
    counts = torch.zeros(words, dtype=torch.int32, device=device)
    run_pull_wave(pg.in_src, pg.edge_epoch, node_epoch, pg.is_real, seeds, inv, counts)
    return inv, pg.is_real.clone(), pg._rows.clone(), blocked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=10_000_000)
    ap.add_argument("--shapes", default="10m,w64,mesh")
    ap.add_argument("--wrappers", action="store_true")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    launchers = build(args.sources)
    shapes, rows = args.shapes.split(","), []
    n = args.nodes
    final, is_real, perm, g0, src, dst, groups = topo_inputs(device, n)
    torch.cuda.empty_cache()
    if "10m" in shapes:
        rows.append(ab_shape(device, f"lane burst, {n} nodes", final, is_real, perm, False,
                             g0, launchers, args.wrappers))
        print(json.dumps(rows[-1]), flush=True)
    if "w64" in shapes:
        final64 = final.repeat(1, 4)
        rows.append(ab_shape(device, f"lane burst at W = 64, {n} nodes", final64, is_real,
                             perm, False, g0, launchers))
        print(json.dumps(rows[-1]), flush=True)
        del final64
    del final, is_real, perm, g0
    torch.cuda.empty_cache()
    if "mesh" in shapes:
        bits, real, ids, blocked = mesh_inputs(device, n, src, dst, groups)
        rows.append(ab_shape(device, f"mesh lane burst, {n} nodes", bits, real, ids, True,
                             blocked, launchers, args.wrappers))
        print(json.dumps(rows[-1]), flush=True)
        rows.append(ab_shape(device, f"mesh lane burst through the row map, {n} nodes", bits,
                             real, ids, False, blocked,
                             {k: v for k, v in launchers.items() if not v[1]}))
        print(json.dumps(rows[-1]), flush=True)
    wrong = [w for r in rows for w in r["wrong"]]
    if wrong:
        print("differ from lane_finish_plain:", wrong, file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
