"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the dense and sharded wave paths on
the card against the same paths on the CPU. Tolerance: exact (integer words, bits and
counts). This file imports torch and the port only — no JAX — so it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Elsewhere every test skips with its reason."""
import functools

import numpy as np
import pytest
import torch

from stl_fusion_tpu_torch.graph import DeviceGraph
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.ops import or_popcount as opc
from stl_fusion_tpu_torch.ops import ring_all_gather as rag
from stl_fusion_tpu_torch.ops import wave as tw
from stl_fusion_tpu_torch.ops.bitops import pack_bits
from stl_fusion_tpu_torch.parallel import PackedShardedGraph, ShardedDeviceGraph, graph_mesh

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [0, 1, 7, 128, 40000, 524289])
def test_or_popcount_kernel_matches_plain(card, n):
    rng = np.random.default_rng(n)
    new = torch.from_numpy(rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)).to(card)
    old = torch.from_numpy(rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)).to(card)
    want_m, want_c = opc.or_popcount_plain(new, old)
    before = opc.launches
    got_m, got_c = opc.or_popcount(new, old)
    torch.cuda.synchronize()
    assert opc.launches == before + 1
    assert torch.equal(got_m, want_m) and int(got_c) == int(want_c)
    got_m, got_c = opc.or_popcount(new, old, out=old)  # in place
    assert torch.equal(old, want_m) and int(got_c) == int(want_c)


def test_or_popcount_rejects_misaligned(card):
    x = torch.zeros(9, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        opc.or_popcount(x[1:], x[:8])
    with pytest.raises(ValueError, match="aligned"):
        opc.or_popcount_gate(x[:8], x[:8], delta=x[1:])
    with pytest.raises(ValueError, match="aligned"):
        opc.or_popcount_delta(x[1:], x[:8])


def test_or_popcount_refuses_graph_capture(card):
    """A launch under CUDA graph capture raises: a replay would run on
    another stream with the capture stream's count accumulators."""
    x = torch.zeros(8, dtype=torch.int32, device=card)
    opc.or_popcount(x, x.clone())  # the kernel is built and loaded outside capture
    torch.cuda.synchronize()
    before = opc.launches
    with pytest.raises(RuntimeError, match="captured"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            opc.or_popcount(x, x.clone())
    assert opc.launches == before
    _, count = opc.or_popcount(x, torch.full_like(x, -1))  # eager launches still count
    assert int(count) == 0


def _random_words(rng, n, card):
    return torch.from_numpy(rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)).to(card)


@pytest.mark.parametrize("n", [1, 3, 7, 128, 40000, 524289])
@pytest.mark.parametrize("alias", [False, True])
def test_or_popcount_forms_match_plain(card, n, alias):
    """Each form, one launch each, against its plain version; with ``alias``
    the merge goes into ``old`` and the delta into ``new`` (the dense
    wave's seed gate), or the delta into ``new`` (the delta form)."""
    rng = np.random.default_rng(n + alias)
    new0, old0 = _random_words(rng, n, card), _random_words(rng, n, card)
    want_m, want_d, want_c = opc.or_popcount_gate_plain(new0.clone(), old0.clone())
    new, old = new0.clone(), old0.clone()
    before = dict(opc.form_launches)
    if alias:
        got_m, got_d, got_c = opc.or_popcount_gate(new, old, out=old, delta=new)
        assert got_m.data_ptr() == old.data_ptr() and got_d.data_ptr() == new.data_ptr()
    else:
        got_m, got_d, got_c = opc.or_popcount_gate(new, old)
        assert torch.equal(new, new0) and torch.equal(old, old0)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m) and torch.equal(got_d, want_d)
    assert got_c.dtype == torch.int64 and int(got_c) == int(want_c)
    new, old = new0.clone(), old0.clone()
    got_d, got_c = opc.or_popcount_delta(new, old, delta=new if alias else None)
    torch.cuda.synchronize()
    assert torch.equal(got_d, want_d) and torch.equal(old, old0) and int(got_c) == int(want_c)
    assert (got_d.data_ptr() == new.data_ptr()) == alias
    new, old = new0.clone(), old0.clone()
    got_m, got_c = opc.or_popcount(new, old, out=old if alias else None)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m) and int(got_c) == int(want_c)
    assert {k: opc.form_launches[k] - before[k] for k in before} == {
        "merge": 1, "gate": 1, "delta": 1, "shards": 0}


def test_or_popcount_ticket_resets_over_100_calls(card):
    """100 launches in a row on one stream, forms and sizes mixed, with no
    sync between them: every count is its own (the last block's ticket is
    back at 0 for the next launch), and each stays valid after the rest."""
    rng = np.random.default_rng(3)
    cases, got = [], []
    for i in range(100):
        n = (1, 7, 40000, 524289)[i % 4]
        new, old = _random_words(rng, n, card), _random_words(rng, n, card)
        cases.append((new, old))
        form = i % 3
        if form == 0:
            got.append(opc.or_popcount(new, old)[1])
        elif form == 1:
            got.append(opc.or_popcount_gate(new, old)[2])
        else:
            got.append(opc.or_popcount_delta(new, old)[1])
    for (new, old), count in zip(cases, got):
        assert int(count) == int(opc.or_popcount_plain(new, old)[1])


def test_or_popcount_counts_past_2_to_the_31(card):
    """67,108,865 all-ones words over zeros light 2,147,483,680 bits: the
    int64 count holds it (the TPU kernel's int32 count wraps there)."""
    n = 67_108_865
    ones = torch.full((n,), -1, dtype=torch.int32, device=card)
    zeros = torch.zeros(n, dtype=torch.int32, device=card)
    want = 32 * n
    assert want == 2_147_483_680
    _, count = opc.or_popcount_delta(ones, zeros)
    assert int(count) == want
    _, _, count = opc.or_popcount_gate(ones, zeros.clone())
    assert int(count) == want
    merged, count = opc.or_popcount(ones, zeros, out=zeros)
    assert int(count) == want and bool((merged == -1).all())


@pytest.mark.parametrize("n_shards, n_local", [(1, 96), (3, 32 * 41), (8, 1_250_016)])
def test_or_popcount_shards_kernel_matches_per_shard_plain(card, n_shards, n_local):
    """One launch over every shard of a one-card mesh against the plain
    per-shard merges; the last case is the 10M mesh's word count (39,064
    words a shard). Each row's padding past the shard's words holds garbage
    that must not be read."""
    rng = np.random.default_rng(n_shards)
    mesh = graph_mesh(n_shards, device=card)
    n = n_local * n_shards
    invalid = rng.random(n) < 0.3
    sg = ShardedDeviceGraph(np.zeros(1, np.int64), np.zeros(1, np.int64), n, mesh=mesh,
                            invalid=invalid)
    table = tw.ShardTable(*sg.g)
    plain_inv = tuple(x.clone() for x in sg.g.invalid)
    plain_table = tw.ShardTable(*sg.g._replace(invalid=plain_inv))
    frontier = _random_words(rng, n_shards * table.width, card).view(n_shards, table.width)
    before = opc.form_launches["shards"]
    counts, total = opc.or_popcount_shards(frontier, table)
    torch.cuda.synchronize()
    assert opc.form_launches["shards"] == before + 1
    want_counts, want_total = opc.or_popcount_shards_plain(frontier, plain_table)
    assert torch.equal(counts, want_counts) and int(total) == int(want_total) > 0
    for got, want in zip(sg.g.invalid, plain_inv):
        assert torch.equal(got, want)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    src, dst = power_law_dag(n, avg_degree=3, seed=seed)
    n_cap = 1 << (n - 1).bit_length()
    ne = np.zeros(n_cap + 1, np.int32)
    ne[n_cap] = -2
    ne[rng.choice(n, n // 10, replace=False)] += 1
    return rng, src, dst, ne, n_cap


def test_wave_expand_kernel_matches_plain(card):
    rng, src, dst, ne, n_cap = _state(20000, 3)
    inv = np.zeros(n_cap + 1, bool)
    inv[rng.choice(20000, 500, replace=False)] = True
    frontier = np.zeros(n_cap + 1, bool)
    frontier[rng.choice(20000, 3000, replace=False)] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    args = (pack_bits(t(frontier)), pack_bits(t(inv)), t(ne), t(src), t(dst),
            t(np.zeros(len(src), np.int32)))
    want = tw.wave_expand_plain(*args)
    before = tw.launches
    got = tw.wave_expand(*args)
    torch.cuda.synchronize()
    assert tw.launches == before + 1
    assert torch.equal(got, want)


def test_device_graph_on_card_matches_cpu(card):
    _, src, dst, _, _ = _state(50000, 5)
    rng = np.random.default_rng(5)
    graphs = [DeviceGraph(50000, len(src), device=d) for d in ("cpu", "cuda")]
    bumped = rng.choice(50000, 500, replace=False)
    seeds = rng.choice(50000, 300, replace=False).tolist()
    shallow = (49999 - rng.choice(500, 64, replace=False)).tolist()
    results = []
    for g in graphs:
        g.add_nodes(50000)
        g.add_edges(src, dst)
        g.bump_epochs(bumped)
        out = [g.run_waves_union([seeds])]
        g.clear_invalid()
        out.append(g.run_wave_collect(shallow, cap=256))
        g.mark_invalid(np.arange(100, 200, dtype=np.int32))
        out.append(g.run_wave([0, 1], with_stats=True))
        out.append(g.invalid_mask())
        results.append(out)
    cpu, gpu = results
    assert cpu[0][0] == gpu[0][0]
    np.testing.assert_array_equal(gpu[0][1], cpu[0][1])
    assert cpu[1][0] == gpu[1][0]
    np.testing.assert_array_equal(gpu[1][1], cpu[1][1])
    assert cpu[2] == gpu[2]
    np.testing.assert_array_equal(gpu[3], cpu[3])


@pytest.mark.parametrize("form", ["list", "rows"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("chunk", [1, 31, 128, 39063])
def test_ring_all_gather_kernel_matches_plain(card, n_shards, chunk, form):
    """From a list, and from the rows of a 2-D tensor whose row stride
    exceeds the chunk (3 words past it: the rows are misaligned for int4,
    so chunks that are a multiple of 4 take the vector path from a list and
    the scalar path from rows): one CUDA launch per gather."""
    rng = np.random.default_rng(1000 * n_shards + chunk)
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(n_shards, chunk + 3),
                                          dtype=np.int32)).to(card)
    chunks = words[:, :chunk] if form == "rows" else [w[:chunk].clone() for w in words]
    want = rag.ring_all_gather_plain(chunks)
    before = (rag.launches, rag.cuda_launches)
    got = rag.ring_all_gather(chunks)
    torch.cuda.synchronize()
    assert (rag.launches, rag.cuda_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (n_shards, n_shards * chunk)
    full = words[:, :chunk].reshape(-1)
    assert torch.equal(got, want)
    for d in range(n_shards):
        assert torch.equal(got[d], full), f"shard {d}"


def _merge_inputs(card, seed, n=20000):
    """A level on the card with the merged kernel's edge cases: stale
    epochs, pre-invalid dependents (some in the frontier), duplicate edges,
    padding edges and a live prefix with a ragged tail of 1-3 edges."""
    rng, src, dst, ne, n_cap = _state(n, seed)
    dup = rng.choice(len(src), 500, replace=False)
    src, dst = np.concatenate([src, src[dup]]), np.concatenate([dst, dst[dup]])
    pad = 4 + seed % 3  # padding slots: src n_cap, dst n_cap, epoch -1
    es = np.concatenate([src, np.full(pad, n_cap)]).astype(np.int32)
    ed = np.concatenate([dst, np.full(pad, n_cap)]).astype(np.int32)
    ee = np.concatenate([np.zeros(len(src)), np.full(pad, -1)]).astype(np.int32)
    n_live = len(es) - (len(es) % 4 == 0)  # drop a padding slot for a ragged tail
    inv = np.zeros(n_cap + 1, bool)
    inv[rng.choice(n, 500, replace=False)] = True
    frontier = np.zeros(n_cap + 1, bool)
    frontier[rng.choice(n, 3000, replace=False)] = True
    frontier[np.nonzero(inv)[0][:50]] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    return (pack_bits(t(frontier)), pack_bits(t(inv)), t(ne), t(es)[:n_live], t(ed)[:n_live],
            t(ee)[:n_live])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_wave_expand_merge_kernel_matches_plain(card, seed):
    fw, inv, ne, es, ed, ee = _merge_inputs(card, seed)
    assert es.shape[0] % 4
    want_inv = inv.clone()
    want, want_c = tw.wave_expand_merge_plain(fw, want_inv, ne, es, ed, ee)
    before = (tw.launches, tw.form_launches["merge"])
    got, got_c = tw.wave_expand_merge(fw, inv, ne, es, ed, ee)
    torch.cuda.synchronize()
    assert (tw.launches, tw.form_launches["merge"]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want) and torch.equal(inv, want_inv)
    assert int(got_c) == int(want_c) > 0
    again, zero = tw.wave_expand_merge(fw, inv, ne, es, ed, ee)  # all lit already
    assert int(zero) == 0 and not again.any()


def test_wave_expand_rejects_misaligned_int4_base(card):
    fw, inv, ne, es, ed, ee = _merge_inputs(card, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tw.wave_expand(fw, inv, ne, es[1:], ed[1:], ee[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tw.wave_expand_merge(fw, inv, ne, es[1:], ed[1:], ee[1:])


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_wave_expand_shards_kernel_matches_per_shard_plain(card, n_shards):
    """One launch for every shard against n single-shard plain levels, on a
    shared 1-D frontier and on 2-D rows."""
    n = 50000
    rng, src, dst, _, _ = _state(n, 11)
    node_epoch = np.zeros(n, np.int32)
    node_epoch[rng.choice(n, 500, replace=False)] = 1
    invalid = np.zeros(n, bool)
    invalid[rng.choice(n, 800, replace=False)] = True
    sg = ShardedDeviceGraph(src, dst, n, mesh=graph_mesh(n_shards, device=card),
                            edge_dst_epoch=np.zeros(len(src), np.int32), node_epoch=node_epoch,
                            invalid=invalid)
    frontier = torch.from_numpy(rng.random(sg.n_global) < 0.05).to(card)
    words = pack_bits(frontier)
    start = [x.clone() for x in sg.g.invalid]
    for fw in (words, torch.stack([words] * n_shards)):
        for x, x0 in zip(sg.g.invalid, start):
            x.copy_(x0)
        table = tw.ShardTable(*sg.g)
        before = tw.form_launches["shards"]
        got, count = tw.wave_expand_shards(fw, table, sg.n_global)
        torch.cuda.synchronize()
        assert tw.form_launches["shards"] == before + 1
        want_count = 0
        for d in range(n_shards):
            ref = start[d].clone()
            nx, lit = tw.wave_expand_merge_plain(words, ref, sg.g.node_epoch[d], sg.g.edge_src[d],
                                                 sg.g.edge_dst_local[d], sg.g.edge_dst_epoch[d])
            assert torch.equal(got[d, :table.words], nx), f"shard {d}"
            assert torch.equal(sg.g.invalid[d], ref), f"shard {d}"
            want_count += int(lit)
        assert not got[:, table.words:].any()
        assert int(count) == want_count > 0


def test_graph_mesh_across_cards_raises(card):
    with pytest.raises(NotImplementedError, match="A.10"):
        graph_mesh(devices=["cuda:0", "cuda:1"])
    assert graph_mesh(devices=["cuda:0"] * 8).size == 8
    assert graph_mesh(devices=["cuda", "cuda:0"]).size == 2  # one card, two names


def test_sharded_graph_on_card_matches_dense_and_cpu(card):
    n = 50000
    _, src, dst, _, _ = _state(n, 7)
    rng = np.random.default_rng(7)
    bumped = rng.choice(n, 500, replace=False)
    node_epoch = np.zeros(n, np.int32)
    node_epoch[bumped] = 1
    edge_epoch = np.zeros(len(src), np.int32)
    seeds = rng.choice(n, 300, replace=False).tolist()
    shallow = (n - 1 - rng.choice(500, 64, replace=False)).tolist()
    results = {}
    for name, dev, exchange in (("ring", "cuda", "ring"), ("bool", "cuda", "bool"),
                                ("cpu", "cpu", "packed")):
        sg = ShardedDeviceGraph(src, dst, n, mesh=graph_mesh(8, device=dev),
                                edge_dst_epoch=edge_epoch, exchange=exchange,
                                node_epoch=node_epoch)
        before = rag.launches
        out = [sg.run_wave(seeds), sg.invalid_mask()]
        if exchange == "ring":
            assert rag.launches > before
        sg.clear_invalid()
        count, ids, overflow = sg.run_wave_collect(shallow, cap=256)
        out += [count, ids, overflow]
        results[name] = out
    dense = DeviceGraph(n, len(src), device="cuda")
    dense.add_nodes(n)
    dense.add_edges(src, dst)
    dense.bump_epochs(bumped)
    want_count, _ = dense.run_waves_union([seeds])
    want_mask = dense.invalid_mask()
    for name, out in results.items():
        assert out[0] == want_count, name
        np.testing.assert_array_equal(out[1], want_mask, err_msg=name)
        assert out[2] == results["cpu"][2] and out[4] == results["cpu"][4], name
        np.testing.assert_array_equal(out[3], results["cpu"][3], err_msg=name)


@pytest.mark.parametrize("words", [1, 2, 16])
@pytest.mark.parametrize("slack", [0, 2])  # k = 4 and k = 6 (the live mirror's rows)
@pytest.mark.parametrize("start_level", [0, 1])
def test_topo_sweep_kernel_matches_plain(card, words, slack, start_level):
    """One launch per non-empty level; bits and per-word counts exact, with
    pre-set bits, blocked rows (epoch -3) and quantization pad rows."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    rng = np.random.default_rng(10 * words + slack)
    src, dst = power_law_dag(30000, avg_degree=3, seed=words)
    g = tpw.build_topo_graph(src, dst, 30000, k=4, slack=slack)
    ga = tpw.topo_graph_arrays(g, card)
    lists = [rng.choice(30000, size=20, replace=False) for _ in range(32 * words)]
    seeds = torch.from_numpy(tpw.topo_seeds_to_bits(g, lists, words=words)).to(card)
    shape = (g.n_tot + 1,) if words == 1 else (g.n_tot + 1, words)
    pre = torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32)).to(card)
    pre[torch.from_numpy(rng.random(g.n_tot + 1) < 0.9).to(card)] = 0
    epochs = tpw.topo_init_state(g.n_tot, device=card).node_epoch
    epochs[torch.from_numpy(g.inv_perm[rng.choice(30000, 300, replace=False)]).to(card)] = -3
    states = [tpw.TopoState(epochs, pre.clone()) for _ in range(2)]
    _, want = tpw.topo_sweep_plain(g.level_starts, ga, seeds, states[0], start_level)
    before = tpw.launches
    _, got = tpw.topo_sweep(g.level_starts, ga, seeds, states[1], start_level)
    torch.cuda.synchronize()
    levels = g.level_starts
    assert tpw.launches - before == sum(b > a for a, b in zip(levels, levels[1:]))
    assert torch.equal(states[1].invalid_bits, states[0].invalid_bits)
    assert torch.equal(got, want) and int(got.sum()) > 0
    # a pass with no seeds finds nothing new
    _, again = tpw.topo_sweep(g.level_starts, ga, None, states[1], start_level)
    assert int(again.sum()) == 0


def test_mirror_routes_on_card_match_cpu(card):
    rng = np.random.default_rng(8)
    src, dst = power_law_dag(50000, avg_degree=3, seed=8)
    graphs = [DeviceGraph(50000, len(src), device=d) for d in ("cpu", "cuda")]
    bumped = rng.choice(50000, 500, replace=False)
    bursts = [rng.choice(50000, 3, replace=False).tolist(),
              rng.choice(50000, 2000, replace=False).tolist(),
              (49999 - rng.choice(500, 200, replace=False)).tolist()]
    results = []
    for g in graphs:
        g.add_nodes(50000)
        g.add_edges(src, dst)
        g.bump_epochs(bumped)
        g.build_topo_mirror()
        out = []
        for seeds in bursts:
            out.append(g.run_waves_union([seeds]))
            g.mark_invalid(np.arange(100, 200, dtype=np.int32))
        out.append(g.invalid_mask())
        out.append((g.mirror_bursts, g.lat_waves))
        results.append(out)
    cpu, gpu = results
    for a, b in zip(cpu[:3], gpu[:3]):
        assert a[0] == b[0]
        np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(gpu[3], cpu[3])
    assert gpu[4] == cpu[4] == (3, 2)


def _lane_finish_inputs(card, words, seed, n_real=20000, n_virtual=3000, empty=False):
    """Random swept lane bits over real and virtual rows, an injective perm
    over the real rows (virtual rows clipped to n_cap), and pre-invalid
    dense words; lane 31 (the sign bit) is set on some rows."""
    rng = np.random.default_rng(seed)
    n_rows = n_real + n_virtual + 1  # + the null row
    n_cap = 1 << n_real.bit_length()
    perm = np.full(n_rows, n_cap, np.int32)
    real_rows = rng.permutation(n_rows - 1)[:n_real]
    perm[real_rows] = rng.permutation(n_real).astype(np.int32)
    is_real = np.zeros(n_rows, bool)
    is_real[real_rows] = True
    bits = rng.integers(-(2**31), 2**31, size=(n_rows, words), dtype=np.int32)
    bits[rng.random(n_rows) < 0.7] = 0
    bits[rng.random(n_rows) < 0.05, 0] = np.int32(-(2**31))
    if empty:
        bits[:] = 0
    pre = np.zeros(n_cap + 1, bool)
    pre[rng.choice(n_real, n_real // 4, replace=False)] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    g_inv = pack_bits(t(pre))
    return t(bits if words > 1 else bits[:, 0]), t(is_real), t(perm), g_inv


@pytest.mark.parametrize("words", [1, 2, 16, 32])
@pytest.mark.parametrize("empty", [False, True])
def test_lane_finish_kernel_matches_plain(card, words, empty):
    """Lane counts, union count, newly mask and the dense words after the
    commit, exact: pre-invalid rows, virtual rows, lane 31, and a burst
    with an empty union."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    bits, is_real, perm, g_inv = _lane_finish_inputs(card, words, 7 + words, empty=empty)
    g_plain = g_inv.clone()
    want = tpw.lane_finish_plain(bits, is_real, perm, g_plain)
    before = tpw.lane_finish_launches
    got = tpw.lane_finish(bits, is_real, perm, g_inv)
    torch.cuda.synchronize()
    assert tpw.lane_finish_launches == before + 1
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(g_inv, g_plain)
    if empty:
        assert int(got[1]) == 0 and int(got[0].sum()) == 0
    else:
        assert int(got[1]) > 0 and int(got[0][31]) > 0


def test_lane_finish_rejects_widths_it_cannot_take(card):
    """Any W >= 1 is taken (ROADMAP C.1); rows of no words are not."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    bits, is_real, perm, g_inv = _lane_finish_inputs(card, 3, 1, n_real=100, n_virtual=10)
    with pytest.raises(ValueError, match="at least one word"):
        tpw.lane_finish(bits[:, :0].contiguous(), is_real, perm, g_inv)


@pytest.mark.parametrize("words", [3, 48, 64])
def test_lane_finish_kernel_any_width_matches_plain(card, words):
    """ROADMAP C.1: widths that are not a power of two <= 32 run as column
    chunks of power-of-two widths plus a commit launch; lane counts, union
    count, newly mask and the committed dense words equal the plain
    version's."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    bits, is_real, perm, g_inv = _lane_finish_inputs(card, words, 5 + words)
    g_plain = g_inv.clone()
    want = tpw.lane_finish_plain(bits, is_real, perm, g_plain)
    before = tpw.lane_finish_launches
    got = tpw.lane_finish(bits, is_real, perm, g_inv)
    torch.cuda.synchronize()
    chunks = {3: 2, 48: 2, 64: 2}[words]
    assert tpw.lane_finish_launches == before + chunks + 1
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]) > 0
    assert torch.equal(got[2], want[2]) and torch.equal(g_inv, g_plain)
    assert int(got[0][32 * (words - 1) + 31]) > 0  # the last word's sign-bit lane


def _lane_finish_edge_inputs(card, words, case, n_rows=4109):
    """Swept lane bits for the kernel's edges: ``n_rows`` not a multiple of
    its 32-row tile, a row map in runs (rows r .. r + 31 map to nodes
    shifted by 7, so each tile straddles two dense words; every fifth run
    reversed), lane 31 of the last word set on some rows. ``case``:
    "mixed" (virtual and pre-invalid rows, empty rows), "all" (every row
    real, valid before and in the union), "none" (bits everywhere, every
    real row pre-invalid: no union)."""
    rng = np.random.default_rng(31 * words + len(case))
    n_nodes = n_rows + 64
    perm = (np.arange(n_rows) + 7).astype(np.int32)
    for a in range(0, n_rows, 160):
        perm[a : a + 32] = perm[a : a + 32][::-1].copy()
    bits = rng.integers(-(2**31), 2**31, size=(n_rows, words), dtype=np.int32)
    bits[rng.random(n_rows) < 0.1, words - 1] |= np.int32(-(2**31))
    is_real = np.ones(n_rows, bool)
    pre = np.zeros(32 * -(-n_nodes // 32), bool)
    if case == "mixed":
        is_real[rng.random(n_rows) < 0.1] = False
        bits[rng.random(n_rows) < 0.3] = 0
        pre[perm[rng.random(n_rows) < 0.25]] = True
    elif case == "all":
        bits[:, 0] |= 1
    else:
        pre[perm] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    return t(bits), t(is_real), t(perm), pack_bits(t(pre))


def _lane_finish_exact(bits, is_real, perm, g_inv, launches=None):
    """The kernel against ``lane_finish_plain`` from the same words; returns
    the kernel's (lane counts, union count)."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    g_plain = g_inv.clone()
    want = tpw.lane_finish_plain(bits, is_real, perm, g_plain)
    before = tpw.lane_finish_launches
    got = tpw.lane_finish(bits, is_real, perm, g_inv)
    torch.cuda.synchronize()
    if launches is not None:
        assert tpw.lane_finish_launches == before + launches
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(g_inv, g_plain)
    return got[0], int(got[1])


@pytest.mark.parametrize("words", [1, 2, 4, 8, 16, 32, 3, 48, 64])
@pytest.mark.parametrize("case", ["mixed", "all", "none"])
def test_lane_finish_kernel_edges(card, words, case):
    """The tiled kernel's edges, exact against the plain version: a ragged
    last tile, tiles straddling dense words, all rows in the union or none,
    pre-invalid and virtual rows, lane 31 of the last word; one launch at a
    power-of-two W <= 32, one per column chunk + 1 otherwise."""
    bits, is_real, perm, g_inv = _lane_finish_edge_inputs(card, words, case)
    chunks = {3: 2, 48: 2, 64: 2}.get(words)
    counts, union = _lane_finish_exact(bits, is_real, perm, g_inv,
                                       1 if chunks is None else chunks + 1)
    if case == "none":
        assert union == 0 and int(counts.sum()) == 0
    else:
        assert union == (bits.shape[0] if case == "all" else union) > 0
        assert int(counts[32 * words - 1]) > 0


@pytest.mark.parametrize("words", [1, 2, 16, 32, 48])
def test_lane_finish_identity_form_matches_row_map(card, words):
    """The identity form (no row map) equals the row-map form with
    ``arange(rows)`` and the plain version: a ragged last tile, more dense
    words than the rows need (the spare mask words are written 0)."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    bits, is_real, _, _ = _lane_finish_edge_inputs(card, words, "mixed")
    rng = np.random.default_rng(words)
    pre = pack_bits(torch.from_numpy(rng.random(32 * 140) < 0.2).to(card))  # 4,480 > 4,109 rows
    rows = torch.arange(bits.shape[0], dtype=torch.int32, device=card)
    g_ident, g_map = pre.clone(), pre.clone()
    got = _lane_finish_exact(bits, is_real, None, g_ident)
    want = tpw.lane_finish(bits, is_real, rows, g_map)
    assert torch.equal(got[0], want[0]) and got[1] == int(want[1]) > 0
    assert torch.equal(g_ident, g_map)


@pytest.mark.parametrize("identity", [False, True])
def test_lane_finish_replays_in_a_cuda_graph(card, identity):
    """One call captured in ``torch.cuda.graph`` and replayed twice, each
    time from restored dense words, equals the plain version: the entry's
    memsets and the launch capture, and nothing reads the host."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    bits, is_real, perm, g0 = _lane_finish_edge_inputs(card, 16, "mixed")
    if identity:
        perm = None
    g_plain = g0.clone()
    want = tpw.lane_finish_plain(bits, is_real, perm, g_plain)
    g_inv = g0.clone()
    tpw.lane_finish(bits, is_real, perm, g_inv)  # built, loaded and warm outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    g_inv.copy_(g0)
    with torch.cuda.graph(graph):
        got = tpw.lane_finish(bits, is_real, perm, g_inv)
    for _ in range(2):
        g_inv.copy_(g0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]) > 0
        assert torch.equal(got[2], want[2]) and torch.equal(g_inv, g_plain)


def _fill_slots(g, rng, n_rows=3000):
    """Fill every free in-slot of ``n_rows`` random rows of levels >= 1 with
    sources from lower levels, 80% live (epoch 0) and 20% dead (epoch 5):
    the builder leaves slots past a row's in-degree (at most 3 here) free."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    starts = np.asarray(g.level_starts)
    in_src, edge_epoch = g.in_src.copy(), g.edge_epoch.copy()
    for r in rng.choice(np.arange(starts[1], starts[-1]), n_rows, replace=False):
        if not g.is_real[r]:
            continue
        lvl = np.searchsorted(starts, r, side="right") - 1
        free = np.nonzero(in_src[r] == g.n_tot)[0]
        in_src[r, free] = rng.integers(0, starts[lvl], size=free.size)
        edge_epoch[r, free] = np.where(rng.random(free.size) < 0.8, 0, 5)
    return g._replace(in_src=in_src, edge_epoch=edge_epoch)


@pytest.mark.parametrize("k", [9, 10, 17])
def test_topo_sweep_kernel_wide_rows_match_plain(card, k):
    """ROADMAP C.2: rows of more than 8 in-slots (``build_topo_mirror(k=8)``
    gives 8 + 2 slack) sweep in chunks of 8 slots; bits and counts equal the
    plain version's, with dead slots (epoch mismatch) in every chunk."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    rng = np.random.default_rng(k)
    src, dst = power_law_dag(20000, avg_degree=3, seed=k)
    g = tpw.build_topo_graph(src, dst, 20000, k=k - 2, slack=2)
    assert g.in_src.shape[1] == k
    g = _fill_slots(g, rng)
    assert (g.in_src[:, 8:] != g.n_tot).any()
    ga = tpw.topo_graph_arrays(g, card)
    for words in (1, 16):
        lists = [rng.choice(20000, size=30, replace=False) for _ in range(32 * words)]
        seeds = torch.from_numpy(tpw.topo_seeds_to_bits(g, lists, words=words)).to(card)
        epochs = tpw.topo_init_state(g.n_tot, device=card).node_epoch
        shape = (g.n_tot + 1,) if words == 1 else (g.n_tot + 1, words)
        states = [tpw.TopoState(epochs, torch.zeros(shape, dtype=torch.int32, device=card))
                  for _ in range(2)]
        _, want = tpw.topo_sweep_plain(g.level_starts, ga, seeds, states[0], 0)
        _, got = tpw.topo_sweep(g.level_starts, ga, seeds, states[1], 0)
        torch.cuda.synchronize()
        assert torch.equal(states[1].invalid_bits, states[0].invalid_bits)
        assert torch.equal(got, want) and int(got.sum()) > 0


def _refresh_case(card, base, n_rows, row_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    n_bits = base + n_rows + 100
    inv = rng.random(n_bits) < 0.4
    words = torch.from_numpy(
        np.packbits(np.concatenate([inv, np.zeros((-n_bits) % 32, bool)]),
                    bitorder="little").view(np.int32).copy()).to(card)
    values = torch.from_numpy(rng.integers(-50, 50, (n_rows, *row_shape)).astype(dtype)).to(card)
    fresh = torch.from_numpy(rng.integers(100, 200, (n_rows, *row_shape)).astype(dtype)).to(card)
    valid = torch.from_numpy(rng.random(n_rows) < 0.5).to(card)
    return words, values, fresh, valid


@pytest.mark.parametrize("base,n_rows", [(0, 4096), (37, 5000), (64, 1), (5, 20)])
@pytest.mark.parametrize("row_shape,dtype", [((), np.float32), ((3,), np.int32),
                                             ((4,), np.float32), ((5,), np.uint8)])
@pytest.mark.parametrize("update_valid", [True, False])
def test_block_refresh_kernel_matches_plain(card, base, n_rows, row_shape, dtype, update_valid):
    """Aligned and unaligned bases and ends, 16-, 4- and 1-byte row chunks:
    values, validity and the words (bits outside the block untouched) equal
    the plain version's; one launch."""
    from stl_fusion_tpu_torch.ops import block_refresh as br

    words, values, fresh, valid = _refresh_case(card, base, n_rows, row_shape, dtype,
                                                base + n_rows)
    pw, pv, pvalid = words.clone(), values.clone(), valid.clone()
    br.block_refresh_plain(pw, pv, fresh, pvalid if update_valid else None, base)
    before = br.launches
    br.block_refresh(words, values, fresh, valid if update_valid else None, base)
    torch.cuda.synchronize()
    assert br.launches == before + 1
    assert torch.equal(words, pw) and torch.equal(values, pv) and torch.equal(valid, pvalid)


def test_topo_sweep_changed_flag_sees_virtual_rows(card):
    """The changed flag is set by a pass that lights only a virtual row
    (the per-word counts cover real rows only, so they read 0), and stays
    clear on the next pass; it agrees with a before/after comparison and
    with the plain version on a random state."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    # level 0: real row 0; level 1: virtual row 1 <- 0; null row 2
    t = lambda a: torch.tensor(a, device=card)  # noqa: E731
    ga = tpw.TopoGraphArrays(t([[2], [0], [2]]).int(), t([[-1], [0], [-1]]).int(),
                             t([True, False, False]))
    st = tpw.TopoState(t([0, 0, -2]).int(), t([1, 0, 0]).int())
    changed = torch.zeros(1, dtype=torch.int32, device=card)
    _, counts = tpw.topo_sweep((0, 1, 2), ga, None, st, 0, changed=changed)
    assert int(counts) == 0 and int(changed) == 1 and st.invalid_bits.tolist() == [1, 1, 0]
    changed.zero_()
    tpw.topo_sweep((0, 1, 2), ga, None, st, 0, changed=changed)
    assert int(changed) == 0

    rng = np.random.default_rng(4)
    src, dst = power_law_dag(20000, avg_degree=3, seed=4)
    g = tpw.build_topo_graph(src, dst, 20000, k=4, slack=2)
    ga = tpw.topo_graph_arrays(g, card)
    for words in (1, 16):
        shape = (g.n_tot + 1,) if words == 1 else (g.n_tot + 1, words)
        pre = torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32)).to(card)
        pre[torch.from_numpy(rng.random(g.n_tot + 1) < 0.95).to(card)] = 0
        pre[g.n_tot] = 0
        epochs = tpw.topo_init_state(g.n_tot, device=card).node_epoch
        states = [tpw.TopoState(epochs, pre.clone()) for _ in range(2)]
        flags = [torch.zeros(1, dtype=torch.int32, device=card) for _ in range(2)]
        tpw.topo_sweep_plain(g.level_starts, ga, None, states[0], 0, changed=flags[0])
        tpw.topo_sweep(g.level_starts, ga, None, states[1], 0, changed=flags[1])
        torch.cuda.synchronize()
        assert torch.equal(states[1].invalid_bits, states[0].invalid_bits)
        want = int(bool((states[1].invalid_bits != pre).any()))
        assert int(flags[1]) == int(flags[0]) == want == 1


# ------------------------------------------------------------------ resident programs
SR_N = 800


def _sr_stack(card):
    """A table-backed 800-row DAG (``tests/test_superround.py``'s) bound as
    one row block on the card, warmed, its topo mirror built."""
    from stl_fusion_tpu_torch import core
    from stl_fusion_tpu_torch.graph import TpuGraphBackend

    src, dst = power_law_dag(SR_N, avg_degree=3, seed=7)
    base = torch.arange(SR_N, dtype=torch.float32, device=card)

    class Dag(core.ComputeService):
        def load(self, ids):
            return np.asarray(ids, dtype=np.float32)

        def load_dev(self, ids, base_dev):
            return base_dev[ids]

        def load_dev_args(self):
            return (base,)

        @core.compute_method(table=core.TableBacking(
            rows=SR_N, batch="load", device_batch="load_dev", device_args="load_dev_args"))
        async def node(self, i: int) -> float:
            return float(i)

    hub = core.FusionHub()
    backend = TpuGraphBackend(hub, node_capacity=SR_N + 8, edge_capacity=len(src) + 512,
                              device=card)
    svc = Dag(hub)
    hub.add_service(svc, "dag")
    table = core.memo_table_of(svc.node)
    block = backend.bind_table_rows(table)
    backend.declare_row_edges(block, src, block, dst)
    backend.warm_block_on_device(block)
    backend.flush()
    backend.graph.build_topo_mirror()
    masks = []
    backend.newly_hooks.append(lambda newly: masks.append(np.asarray(newly).copy()))
    return backend, table, block, masks


def _sr_bursts(seed, k):
    rng = np.random.default_rng(seed)
    return [[rng.choice(SR_N, size=3, replace=False).tolist() for _ in range(40)]
            for _ in range(k)]


def _sr_state(backend, table):
    return (backend.graph.device_arrays().invalid.cpu(), table._values.cpu(),
            table.valid_mask.cpu(), table._stale_host.copy())


def _sequential(card, rounds):
    """The twin: one ``cascade_rows_lanes`` + ``refresh_block_on_device``
    pair per round, stream-ordered."""
    backend, table, block, masks = _sr_stack(card)
    counts = []
    for groups in rounds:
        counts.append(backend.cascade_rows_lanes(block, groups))
        backend.refresh_block_on_device(block)
    return counts, masks, _sr_state(backend, table)


def _same(got, want):
    (gc, gm, gs), (wc, wm, ws) = got, want
    assert [c.tolist() for c in gc] == [c.tolist() for c in wc]
    assert len(gm) == len(wm) and all(np.array_equal(a, b) for a, b in zip(gm, wm))
    for a, b in zip(gs, ws):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b))


def _routes(prog):
    return [h["route"] for h in prog.history]


def test_captured_superround_equals_stream_ordered_rounds(card):
    """Three super-rounds of depth 3. The first captures its graph with the
    validity update (the warm left the table's device validity current); its
    harvest marks rows stale, so the next ones leave validity to the host and
    capture that program once, then replay it. Counts, per-round masks, the
    invalid words, values, validity and staleness equal the sequential pairs
    bit for bit, and no round was eager. The burst→refresh chain goes the
    same way."""
    rounds = [r for s in range(3) for r in _sr_bursts(s, 3)]
    backend, table, block, masks = _sr_stack(card)
    prog = backend.enable_super_rounds(block, depth=3)
    counts = []
    for s in range(3):
        counts += prog.dispatch(prog.stage(rounds[3 * s: 3 * s + 3])).harvest()
    st = prog.stats()
    assert st["eager_rounds"] == 0 and st["faults"] == 0, st
    assert _routes(prog) == ["capture", "capture", "replay"], _routes(prog)
    assert (st["captures"], st["replays"], st["recaptures"]) == (2, 3, 0), st
    _same((counts, masks, _sr_state(backend, table)), _sequential(card, rounds))
    backend2, table2, block2, masks2 = _sr_stack(card)
    got, routes = [], []
    for s in range(3):
        got += backend2.cascade_rows_lanes_refresh_chain(block2, rounds[3 * s: 3 * s + 3])
        routes += backend2.graph.last_harvest_info["routes"]
    assert routes == ["capture", "capture", "replay"], routes
    _same((got, masks2, _sr_state(backend2, table2)), _sequential(card, rounds))


def test_superround_recaptures_when_a_captured_tensor_moves(card):
    """A dirty graph re-uploads its invalid words as a new tensor, and a
    forced re-level installs new mirror tables with the same levels (the
    same key): the next dispatch must re-capture (counted), never replay
    against the old addresses; the results stay equal to the sequential
    pairs."""
    rounds = [r for s in range(5) for r in _sr_bursts(10 + s, 2)]
    backend, table, block, masks = _sr_stack(card)
    prog = backend.enable_super_rounds(block, depth=2)
    counts = []
    for s in range(5):
        if s == 3:
            old_words = backend.graph.device_arrays().invalid
            backend.graph._dirty = True  # the next device_arrays() re-uploads
        if s == 4:
            assert backend.graph.device_arrays().invalid.data_ptr() != old_words.data_ptr()
            levels = backend.graph._topo_mirror["level_starts"]
            backend.graph.build_topo_mirror(force=True)  # new garrays
            assert backend.graph._topo_mirror["level_starts"] == levels
        counts += prog.dispatch(prog.stage(rounds[2 * s: 2 * s + 2])).harvest()
    assert _routes(prog) == ["capture", "capture", "replay", "recapture", "recapture"]
    st = prog.stats()
    assert st["recaptures"] == 2 and st["eager_rounds"] == 0, st
    _same((counts, masks, _sr_state(backend, table)), _sequential(card, rounds))


def test_replay_advances_the_launch_counters(card):
    """Capture launches nothing, so the counters roll back after it; each
    replay adds what the graph holds: per round, one ``topo_sweep`` launch
    per non-empty level and pass, one ``lane_finish``, one ``block_refresh``.
    A dispatch that captures also warms on clones first (real launches)."""
    from stl_fusion_tpu_torch.ops import block_refresh as brf
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    backend, table, block, _ = _sr_stack(card)
    prog = backend.enable_super_rounds(block, depth=3)
    m = backend.graph._topo_mirror
    ls = m["level_starts"]
    levels = sum(1 for a, b in zip(ls, ls[1:]) if a < b) or 1
    want = (3 * levels * m["passes"], 3, 3)
    for s in range(4):
        staged = prog.stage(_sr_bursts(20 + s, 3))
        before = (tpw.launches, tpw.lane_finish_launches, brf.launches)
        prog.dispatch(staged).harvest()
        torch.cuda.synchronize()
        after = (tpw.launches, tpw.lane_finish_launches, brf.launches)
        got = tuple(a - b for a, b in zip(after, before))
        times = 1 if prog.history[-1]["route"] == "replay" else 2
        assert got == tuple(times * w for w in want), (s, got, want)
    assert _routes(prog) == ["capture", "capture", "replay", "replay"]


def test_superround_clean_path_has_no_eager_rounds(card):
    """A stream of super-rounds with churn between them (edges declared,
    flushed and patched into the mirror in place): every one replays or
    captures, none falls back."""
    rng = np.random.default_rng(5)
    backend, table, block, _ = _sr_stack(card)
    prog = backend.enable_super_rounds(block, depth=3)
    for s in range(4):
        m = backend.graph._topo_mirror
        a, b = rng.integers(0, SR_N, size=(2, 6))
        la, lb = (np.searchsorted(m["level_starts_arr"], m["inv_perm"][x], side="right")
                  for x in (a, b))
        keep = la < lb  # level-ordered: each patches in without another pass
        backend.declare_row_edges(block, a[keep], block, b[keep])
        backend.flush()
        backend.refresh_block_on_device(block)
        prog.dispatch(prog.stage(_sr_bursts(30 + s, 3))).harvest()
    st = prog.stats()
    assert st["eager_rounds"] == 0 and st["faults"] == 0 and st["uncaptured"] == 0, st
    assert st["replays"] == 4


# ------------------------------------------------------------------ packed_pull
def _pull_inputs(card, words, k, seed, n=6000):
    """A random in-slot table of ``k`` slots (live, dead and pad slots; the
    null row ``n - 1``), epochs, real rows, a sparse frontier with the
    sign-bit lane set, and an invalid state, on the card."""
    rng = np.random.default_rng(seed)
    in_src = rng.integers(0, n, size=(n, k)).astype(np.int32)
    node_epoch = rng.integers(0, 3, size=n).astype(np.int32)
    node_epoch[n - 1] = -2
    edge_epoch = np.where(rng.random((n, k)) < 0.6, node_epoch[:, None],
                          node_epoch[:, None] + 1).astype(np.int32)
    pad = rng.random((n, k)) < 0.2
    in_src[pad], edge_epoch[pad] = n - 1, -1
    is_real = rng.random(n) < 0.9
    frontier = rng.integers(-(2**31), 2**31, size=(n, words), dtype=np.int64).astype(np.int32)
    frontier[rng.random(n) < 0.8] = 0
    frontier[rng.random(n) < 0.05, words - 1] |= np.int32(-(2**31))
    invalid = rng.integers(-(2**31), 2**31, size=(n, words), dtype=np.int64).astype(np.int32)
    invalid[rng.random(n) < 0.6] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(card)  # noqa: E731
    return [t(a) for a in (in_src, edge_epoch, node_epoch, is_real, frontier, invalid)]


@pytest.mark.parametrize("words", [1, 3, 16, 32])
@pytest.mark.parametrize("k", [8, 10, 17])
def test_packed_pull_kernel_matches_plain(card, words, k):
    """One level and one seed step, each with and without ``count_all``:
    next, invalid, counts and the flag equal the plain version's, the null
    row's fire 0; with the incoming flag at 0 the launch changes nothing."""
    from stl_fusion_tpu_torch.ops import packed_pull as ppp

    in_src, edge_epoch, node_epoch, is_real, frontier, invalid = _pull_inputs(
        card, words, k, 100 * words + k)
    n = invalid.shape[0]
    for gather, count_all in ((True, False), (True, True), (False, False), (False, True)):
        outs = []
        for fn in (ppp.packed_pull_plain, ppp.packed_pull):
            inv, nxt = invalid.clone(), torch.full_like(invalid, 7)
            counts = torch.zeros(words, dtype=torch.int32, device=card)
            flags = torch.tensor([1, 0], dtype=torch.int32, device=card)
            before = ppp.launches
            fn(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv, counts, gather=gather,
               flag_in=flags[:1], flag_out=flags[1:], null_row=n - 1, count_all=count_all)
            torch.cuda.synchronize()
            if fn is ppp.packed_pull:
                assert ppp.launches == before + 1
            outs.append((inv, nxt, counts, flags))
        for a, b in zip(*outs):
            assert torch.equal(a, b), (gather, count_all)
        inv, nxt, counts, flags = outs[1]
        assert int(flags[1]) == 1 and int(counts.sum()) > 0
        if gather:
            assert int(nxt[n - 1].abs().sum()) == 0
    # the early exit: nothing is read or written when the flag is 0
    inv, nxt = invalid.clone(), torch.full_like(invalid, 7)
    counts = torch.zeros(words, dtype=torch.int32, device=card)
    flags = torch.zeros(2, dtype=torch.int32, device=card)
    ppp.packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv, counts,
                    flag_in=flags[:1], flag_out=flags[1:])
    torch.cuda.synchronize()
    assert torch.equal(inv, invalid) and int((nxt != 7).sum()) == 0
    assert int(counts.abs().sum()) == 0 and int(flags[1]) == 0


def _summary_inputs(card, words, k, density, n, seed):
    """``_pull_inputs``' tables (the null row ``n - 1``) with a frontier
    whose rows are lit at ``density`` (at least one), random words in every
    other row (garbage under a clear bit), and the summary of the lit rows."""
    in_src, edge_epoch, node_epoch, is_real, _, invalid = _pull_inputs(card, words, k, seed, n=n)
    rng = np.random.default_rng(seed + 1)
    lit = rng.random(n) < density
    lit[rng.integers(n)] = True
    words_ = rng.integers(-(2**31), 2**31, size=(n, words), dtype=np.int64).astype(np.int32)
    words_[lit, 0] |= 1  # a lit row is non-zero
    frontier = torch.from_numpy(words_).to(card)
    return (in_src, edge_epoch, node_epoch, is_real, frontier, invalid,
            pack_bits(torch.from_numpy(lit).to(card)))


@pytest.mark.parametrize("words", [1, 3, 16, 32])
@pytest.mark.parametrize("k", [8, 10, 17, 40])  # 40: slots past the scan's 32
@pytest.mark.parametrize("density", [0.001, 0.01, 0.5])
def test_packed_pull_summary_kernel_matches_plain(card, words, k, density):
    """The fired summary: a level given the previous level's summary (the
    frontier's other rows garbage) and writing its own, and the seed step
    writing the first, each with and without ``count_all``, on 6,001 rows
    and on 23 (a partial summary word, below 32), the null row last: next
    (only the rows that fire written), invalid, counts, the flag and the
    summary equal the plain version's; with the incoming flag at 0 the
    launch writes neither next nor the summary."""
    from stl_fusion_tpu_torch.ops import packed_pull as ppp

    for n in (6001, 23):
        in_src, edge_epoch, node_epoch, is_real, frontier, invalid, summary = _summary_inputs(
            card, words, k, density, n, 1000 * words + 10 * k + n)
        n_words = summary.shape[0]
        for gather, count_all in ((True, False), (True, True), (False, False), (False, True)):
            outs = []
            for fn in (ppp.packed_pull_plain, ppp.packed_pull):
                inv, nxt = invalid.clone(), torch.full_like(invalid, 7)
                counts = torch.zeros(words, dtype=torch.int32, device=card)
                flags = torch.tensor([1, 0], dtype=torch.int32, device=card)
                s_out = torch.full((n_words,), 12345, dtype=torch.int32, device=card)
                fn(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv, counts,
                   gather=gather, flag_in=flags[:1], flag_out=flags[1:], null_row=n - 1,
                   count_all=count_all, summary_in=summary if gather else None,
                   summary_out=s_out)
                torch.cuda.synchronize()
                outs.append((inv, nxt, counts, flags, s_out))
            for a, b in zip(*outs):
                assert torch.equal(a, b), (n, gather, count_all)
            fired = (outs[1][1] != 7).any(dim=1)  # no fired row is all 7s here
            assert int(fired.sum()) > 0 and int(outs[1][3][1]) == 1
        # the early exit: nothing is read or written when the flag is 0
        inv, nxt = invalid.clone(), torch.full_like(invalid, 7)
        counts = torch.zeros(words, dtype=torch.int32, device=card)
        flags = torch.zeros(2, dtype=torch.int32, device=card)
        s_out = torch.full((n_words,), 12345, dtype=torch.int32, device=card)
        ppp.packed_pull(in_src, edge_epoch, node_epoch, is_real, frontier, nxt, inv, counts,
                        flag_in=flags[:1], flag_out=flags[1:], summary_in=summary,
                        summary_out=s_out)
        torch.cuda.synchronize()
        assert torch.equal(inv, invalid) and int((nxt != 7).sum()) == 0
        assert int((s_out != 12345).sum()) == 0
        assert int(counts.abs().sum()) == 0 and int(flags[1]) == 0


@pytest.mark.parametrize("words", [1, 16])
def test_packed_pull_unaligned_slot_tables_match_plain(card, words):
    """Slot tables at k = 8 that start 4 bytes off a 16-byte boundary take
    the scalar slot loads (and at k = 10, 8 bytes off, the int2 ones): the
    level equals the plain version's."""
    from stl_fusion_tpu_torch.ops import packed_pull as ppp

    for k, shift in ((8, 1), (8, 2), (10, 1)):
        in_src, edge_epoch, node_epoch, is_real, frontier, invalid, summary = _summary_inputs(
            card, words, k, 0.05, 3001, 7 * k + shift)
        tables = []
        for t in (in_src, edge_epoch):
            buf = torch.empty(t.numel() + shift, dtype=torch.int32, device=card)
            view = buf[shift:].view(t.shape)
            view.copy_(t)
            tables.append(view)
        assert ppp._slot_vec(k, *tables) < (4 if k == 8 else 2)
        outs = []
        for fn, (src, ep) in ((ppp.packed_pull_plain, (in_src, edge_epoch)),
                              (ppp.packed_pull, tables)):
            inv, nxt = invalid.clone(), torch.full_like(invalid, 7)
            counts = torch.zeros(words, dtype=torch.int32, device=card)
            s_out = torch.zeros_like(summary)
            fn(src, ep, node_epoch, is_real, frontier, nxt, inv, counts, null_row=3000,
               summary_in=summary, summary_out=s_out)
            torch.cuda.synchronize()
            outs.append((inv, nxt, counts, s_out))
        for a, b in zip(*outs):
            assert torch.equal(a, b), (k, shift)


@pytest.mark.parametrize("group", [1, 3, 8])
def test_packed_wave_on_card_matches_cpu(card, group, monkeypatch):
    """Whole packed waves on the card (W = 16, levels in groups of 1, 3 and
    8 — the default — and their early exits) equal the CPU port: words,
    counts and levels."""
    from stl_fusion_tpu_torch.ops import packed_pull as ppp

    monkeypatch.setattr(ppp, "GROUP", group)

    n = 20_000
    src, dst = power_law_dag(n, avg_degree=3, seed=4)
    rng = np.random.default_rng(4)
    lists = [rng.choice(n, size=30, replace=False) for _ in range(512)]
    res = {}
    for dev in ("cpu", card):
        pg = PackedShardedGraph(src, dst, n, mesh=graph_mesh(8, device=dev), words=16)
        seeds = pg.prepare_seeds(lists)
        counts = torch.zeros(16, dtype=torch.int32, device=pg.invalid.device)
        stats = {}
        levels = ppp.run_pull_wave(pg.in_src, pg.edge_epoch, pg.node_epoch, pg.is_real, seeds,
                                   pg.invalid, counts, stats=stats)
        res[str(dev)] = (pg.invalid.cpu(), counts.cpu(), levels, stats)
    (ci, cc, cl, _), (gi, gc, gl, gs) = res["cpu"], res[str(card)]
    assert torch.equal(ci, gi) and torch.equal(cc, gc) and cl == gl > 2
    # the last level run lit nothing; the launches after it in its group exited
    assert gs["syncs"] == -(-gl // group) and gs["early_exits"] == gs["syncs"] * group - gl


def test_run_gated_lanes_on_card_matches_cpu(card):
    """The mesh lane burst on the card (``packed_pull`` levels, then
    ``lane_finish``) equals the CPU port: counts, union ids, blocked mask
    and overflow, over two chunks from a pre-blocked state."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    n = 30_000
    src, dst = power_law_dag(n, avg_degree=3, seed=6)
    rng = np.random.default_rng(6)
    groups = [rng.choice(n, size=8, replace=False).tolist() for _ in range(600)]
    pre = np.zeros(n, bool)
    pre[rng.choice(n, n // 20, replace=False)] = True
    res = {}
    for dev in ("cpu", card):
        pg = PackedShardedGraph(src, dst, n, mesh=graph_mesh(8, device=dev), slack=2)
        before = tpw.lane_finish_launches
        counts, ids, blocked, over = pg.run_gated_lanes(groups, pg.put_blocked(pre))
        if dev != "cpu":
            assert tpw.lane_finish_launches == before + 2  # one a chunk
        res[str(dev)] = (counts, ids, pg.blocked_host(blocked), over)
    for a, b in zip(res["cpu"], res[str(card)]):
        assert np.array_equal(a, b)
    assert res["cpu"][1].size > 0 and not res["cpu"][3]


def test_cascade_rows_lanes_sharded_on_card_equals_cascade_rows_lanes(card):
    """One mesh lane burst on the card's 8 logical shards equals the
    single-device ``cascade_rows_lanes`` from the same state: per-group
    counts, the union and the table's stale rows."""
    results = []
    for sharded in (True, False):
        backend, table, block, _ = _sr_stack(card)
        groups = _sr_bursts(11, 1)[0]
        if sharded:
            counts = backend.cascade_rows_lanes_sharded(block, groups, graph_mesh(8, device=card))
            assert backend._packed_mirror["graph"].in_src.device.type == "cuda"
        else:
            counts = backend.cascade_rows_lanes(block, groups)
        results.append((counts, backend.graph._h_invalid[:SR_N].copy(),
                        np.asarray(table._stale_host).copy()))
    for a, b in zip(*results):
        assert np.array_equal(a, b)
    assert results[0][0].sum() > 0


def _oplog_lane_replay(device, n: int = 20_000, ops: int = 512, seeds: int = 8):
    """The op-log reader's batch replay on ``device``: host A (no graph
    backend) commits ``ops`` row writes of ``seeds`` rows each through its
    commander into an in-memory log; host B (a graph backend on
    ``device``, a 20,000-row table bound as one block with
    ``power_law_dag``'s edges declared, its topo mirror built) holds each
    written row as a live node and replays the batch with ``read_new()``.
    Returns the burst's lane counts, host B's invalid mask and stale rows,
    and the written rows read back."""
    import asyncio
    import dataclasses

    from stl_fusion_tpu_torch import core
    from stl_fusion_tpu_torch.graph import TpuGraphBackend
    from stl_fusion_tpu_torch.live_path import make_dag_service
    from stl_fusion_tpu_torch.oplog import InMemoryOperationLog, attach_operation_log

    @dataclasses.dataclass(frozen=True)
    class RowsSet:
        rows: tuple
        value: float

    async def run():
        src, dst = power_law_dag(n, avg_degree=3, seed=7)
        dag_type = make_dag_service(core, n, lambda a: torch.from_numpy(a).to(device))
        dag_type.node.__compute_method_def__.table.device = device
        hub_b = core.FusionHub()
        backend = TpuGraphBackend(hub_b, node_capacity=n + 64, edge_capacity=len(src) + 4096,
                                  device=device)
        svc_b = dag_type(hub_b)
        hub_b.add_service(svc_b, "dag")
        table = core.memo_table_of(svc_b.node)
        block = backend.bind_table_rows(table)
        backend.declare_row_edges(block, src, block, dst)
        backend.warm_block_on_device(block)
        backend.flush()
        backend.build_topo_mirror()
        base, base_dev = svc_b.base, svc_b.load_dev_args()[0]

        def host(hub, dag):
            async def rows_set(command):
                if core.is_invalidating():
                    for r in command.rows:
                        await dag.node(int(r))
                    return
                rows = np.asarray(command.rows, np.int64)
                base[rows] = command.value
                base_dev[torch.from_numpy(rows).to(device)] = command.value

            hub.commander.add_handler(rows_set, command_type=RowsSet)

        hub_a = core.FusionHub()
        dag_a = dag_type(hub_a)
        dag_a.base, dag_a._base_dev = base, base_dev
        host(hub_a, dag_a)
        host(hub_b, svc_b)
        log = InMemoryOperationLog()
        attach_operation_log(hub_a.commander, log, start_reader=False)
        reader = attach_operation_log(hub_b.commander, log, start_reader=False)
        rng = np.random.default_rng(5)
        groups = [n // 2 + rng.choice(n // 2, size=seeds, replace=False) for _ in range(ops)]
        rows = np.unique(np.concatenate(groups))
        nodes = [await core.capture(lambda: svc_b.node(int(r))) for r in rows]
        backend.flush()
        for i, g in enumerate(groups):
            await hub_a.commander.call(RowsSet(tuple(g.tolist()), float(1_000_000 + i)))
        bursts = []
        lanes = backend.invalidate_cascade_batch_lanes
        backend.invalidate_cascade_batch_lanes = lambda gs: bursts.append(lanes(gs)) or bursts[-1]
        assert await reader.read_new() == ops
        assert len(bursts) == 1 and len(bursts[0]) == ops and len(nodes) == rows.size
        union = backend.graph._h_invalid[:n].copy()
        stale = np.asarray(table._stale_host).copy()
        got = table.read_batch(torch.from_numpy(rows).to(device)).cpu().numpy()
        scalar = np.asarray([await svc_b.node(int(r)) for r in rows], np.float32)
        assert np.array_equal(got, base[rows]) and np.array_equal(scalar, base[rows])
        return bursts[0], union, stale, got

    return asyncio.run(run())


def test_oplog_lane_replay_on_card_matches_cpu(card):
    """The op-log reader's 512-lane batch replay (one
    ``invalidate_cascade_batch_lanes`` burst: ``topo_sweep`` and
    ``lane_finish`` on the card) at 20,000 nodes equals the same replay on
    the CPU: lane counts, the union, the stale rows and the values read
    back."""
    from stl_fusion_tpu_torch.ops import topo_wave as tpw

    want = _oplog_lane_replay(torch.device("cpu"))
    before = (tpw.launches, tpw.lane_finish_launches)
    got = _oplog_lane_replay(card)
    assert tpw.launches > before[0] and tpw.lane_finish_launches > before[1]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert want[0].sum() > 0 and want[1].any()


def test_remote_table_host_reads_a_card_table_into_ndarrays(card):
    """``RemoteTableHost`` over a ``MemoTable`` on the card: each
    ``read_batch`` RPC crosses to the host once and returns an ndarray equal
    to the base, and a ``RemoteTable`` client reads the same rows."""
    import asyncio

    from stl_fusion_tpu_torch.client import TABLE_RPC_SERVICE, RemoteTable, RemoteTableHost
    from stl_fusion_tpu_torch.ops.memo_table import MemoTable
    from stl_fusion_tpu_torch.rpc import RpcHub, RpcTestTransport

    base = np.arange(5000, dtype=np.float32) * 3.0
    ids = np.random.default_rng(5).choice(5000, size=1200, replace=False)

    async def run():
        server, reader = RpcHub("server"), RpcHub("client")
        RpcTestTransport(reader, server, wire_codec=True)
        table = MemoTable(5000, lambda rows: base[np.asarray(rows, dtype=np.int64)], device=card)
        assert table.values.is_cuda
        RemoteTableHost(server).expose("t", table)
        service = server.service_registry.require(TABLE_RPC_SERVICE)
        direct = await service.method("read_batch").fn("t", ids)
        remote = RemoteTable(reader, "default", "t")
        got = await remote.read_batch(ids)
        await reader.stop()
        await server.stop()
        return direct["values"], got

    direct, got = asyncio.run(run())
    assert isinstance(direct, np.ndarray) and isinstance(got, np.ndarray)
    assert np.array_equal(direct, base[ids]) and np.array_equal(got, base[ids])


def test_fanout_index_on_card_fences_exactly_the_union(card):
    """A small lane burst on a card backend: ``FanoutRun`` holds the fenced
    (client, key) pairs equal to the subscribed keys inside the dense
    wave's union (and no key outside it), each by one entry; the burst, the
    frames and the device waves by kind equal the same run on the CPU."""
    from stl_fusion_tpu_torch.fanout_path import run_fanout

    edges = power_law_dag(20_000, avg_degree=3, seed=7)
    shape = dict(n_nodes=20_000, clients=4, keys_per_client=4, rounds=1, groups=8,
                 seeds_per_group=4, modes=("coalesced",), lone_samples=0, outside_keys=2,
                 edges=edges)
    got = [run_fanout(**shape, device=dev) for dev in (card, "cpu")]
    keys = ("union", "coalesced_clients_fenced_total", "coalesced_burst_inv_total",
            "coalesced_batch_frames", "coalesced_invalidations_posted", "coalesced_dispatches")
    assert [{k: r[k] for k in keys} for r in got][0] == {k: got[1][k] for k in keys}
    assert got[0]["coalesced_clients_fenced_total"] == 16


def test_edge_twin_on_card_matches_the_cpu(card):
    """The edge twin at small size on a card backend (2 edges with one
    delivery worker each, 2,000 sessions over 64 keys, 2 rounds, the block
    value plane, the smoke leg): its deliveries a round, subscriptions,
    encodes, block hits and device waves by kind equal the same run's on the
    CPU."""
    from stl_fusion_tpu_torch.edge_path import run_edge

    edges = power_law_dag(20_000, avg_degree=3, seed=7)
    shape = dict(n_nodes=20_000, edge_nodes=2, sessions=2_000, keys=64, workers=1, edges=edges)
    got = [run_edge(**shape, device=dev) for dev in (card, "cpu")]
    keys = ("subscriptions", "upstream_subs_per_edge", "server_subscriptions", "fenced_total",
            "frames_encoded", "block_hits_total", "upstream_rpcs_total", "evictions",
            "dispatches")
    assert [{k: r[k] for k in keys} for r in got][0] == {k: got[1][k] for k in keys}
    assert ([(x["inv"], x["deliveries"], x["upstream"]) for x in got[0]["rounds"]]
            == [(x["inv"], x["deliveries"], x["upstream"]) for x in got[1]["rounds"]])
    assert got[0]["server_subscriptions"] == 128 and got[0]["upstream_rpcs_per_burst"] == 0
    assert got[0]["dispatches"]["rounds"]["kinds"]["lanes"]["dispatches"] == 2


def _watchdog_scenario(device):
    """A fused lane burst, an injected fault (the split host loop), the
    second host burst and the oracle-verified fused burst on a 20,000-node
    live stack: each burst's counts and union, and the watchdog's counters."""
    from stl_fusion_tpu_torch.fanout_path import build_stack, port_api
    from stl_fusion_tpu_torch.resilience import ResilienceEvents, WaveWatchdog

    ctx = build_stack(port_api(device), 20_000)
    backend, block = ctx["backend"], ctx["block"]
    dg = backend.graph
    # a generous deadline: the card's first burst pays the kernels' build
    wd = backend.attach_watchdog(WaveWatchdog(deadline_s=600.0, recovery_bursts=2,
                                              events=ResilienceEvents()))
    rng = np.random.default_rng(1414)
    out = []
    for inject in (False, True, False, False):
        rows = 19_999 - rng.choice(5_000, size=512, replace=False)
        before = dg._h_invalid.copy()
        if inject:
            wd.inject_fault_next()
        counts = backend.cascade_rows_lanes(block, [rows[i::32] for i in range(32)])
        union = np.nonzero(dg._h_invalid & ~before)[0]
        out.append((np.asarray(counts).tolist(), union.tolist(), wd.mode))
        backend.refresh_block_on_device(block)
    return out, wd.snapshot()


def test_watchdog_fault_host_loop_and_oracle_on_card_match_cpu(card):
    """The watchdog on a card backend: the fused burst, the injected fault's
    split host loop (dense waves on the card), the recovery burst and the
    oracle-verified re-engagement give the CPU run's counts, unions and
    counters exactly."""
    got, want = _watchdog_scenario(card), _watchdog_scenario("cpu")
    assert got == want
    bursts, snap = got
    assert [mode for _c, _u, mode in bursts] == ["fused", "host", "fused", "fused"]
    assert snap["faults"] == 1 and snap["fallbacks"] == 2 and snap["reengages"] == 1
    assert snap["oracle_checks"] == 1 and snap["oracle_mismatches"] == 0


def test_read_twin_device_ids_and_chain_on_card(card):
    """The read twin's device-id reader and device chain on a card table:
    every reader's rows, the table equal to the DAL after the mutator, and
    the chain's readback equal to the same gathers in plain torch on the
    CPU."""
    from stl_fusion_tpu_torch.read_throughput import run_read

    sizes = {"fusion_vectorized_device_ids": (8, 65_536), "fusion_device_chained": (8, 65_536)}
    rec = run_read(modes=("fusion_vectorized_device_ids", "fusion_device_chained"), sizes=sizes,
                   device=card)
    assert rec["modes"]["fusion_vectorized_device_ids"]["ops"] == 4 * 8 * 65_536
    assert rec["modes"]["fusion_device_chained"]["ops"] == 8 * 65_536
    assert rec["fusion_device_chained"] > 0


# ---------------------------------------------------------------- routed_level
def _routed_pair(card, exchange, dph=None, depth=0, n=6000):
    """The same routed graph on the card and on the CPU (8 logical shards)."""
    from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap
    from stl_fusion_tpu_torch.parallel import RoutedShardedGraph

    src, dst = power_law_dag(n, avg_degree=3.0, seed=3)
    epoch = np.zeros(n, np.int32)
    epoch[np.random.default_rng(2).choice(n, n // 50, replace=False)] = 1
    pl = DevicePlacement.build(ShardMap.initial(["a", "b"], n_shards=32), 8, n,
                               devices_per_host=dph)
    kw = dict(edge_dst_epoch=np.zeros(len(dst), np.int32), node_epoch=epoch, exchange=exchange,
              exchange_async=depth > 0, async_depth=max(depth, 1))
    return [RoutedShardedGraph(src, dst, n, pl, mesh=graph_mesh(devices=[d] * 8), **kw)
            for d in (card, torch.device("cpu"))]


@pytest.mark.parametrize("exchange,dph", [("a2a", None), ("tree", None), ("gather", None),
                                          ("hier", 4)])
@pytest.mark.parametrize("form", ["level", "spec", "resized"])
def test_routed_level_kernel_matches_plain(card, exchange, dph, form):
    """One level of every shard (the exchange level, the speculative local
    level, and the level after an in-place bucket resize) on the card
    against the plain version, from the same frontier and invalid state."""
    from stl_fusion_tpu_torch.ops import routed_wave as rw

    g, _cpu = _routed_pair(card, exchange, dph)
    if form == "resized":
        assert g._try_grow("bucket", g.bucket_cap + 1)
        if exchange == "hier":
            assert g._try_grow("hbucket", g.hbucket_cap + 1)
    rng = np.random.default_rng(7)
    rows = g.perm[rng.choice(g.n_nodes, 300, replace=False)]
    f = g._words_of_rows(rows)
    inv0 = torch.from_numpy(np.random.default_rng(8).integers(
        -(2**31), 2**31, g.n_words, dtype=np.int32) & 0x11111111).to(card)
    w = g._wave
    spec = form == "spec"
    x, stride, cross = (f, g.w_local, None) if spec else w.exchange(f)
    outs = []
    for fn in (rw.routed_level, rw.routed_level_plain):
        inv, nxt = inv0.clone(), torch.zeros_like(f)
        acc = f.clone()
        out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=card)
        before = rw.launches
        fn(x, stride, cross, w.layout, w.nepoch, inv, nxt, out, acc=acc, spec=spec)
        torch.cuda.synchronize()
        if fn is rw.routed_level:
            assert rw.launches == before + 1
        outs.append((inv, nxt, acc, out))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][3][g.n_dev]) > 0
    # a launch whose count it waits on is 0 does nothing
    inv, nxt = inv0.clone(), torch.zeros_like(f)
    out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=card)
    zero = torch.zeros((), dtype=torch.int64, device=card)
    rw.routed_level(x, stride, cross, w.layout, w.nepoch, inv, nxt, out, go=zero, spec=spec)
    assert torch.equal(inv, inv0) and not bool(nxt.any()) and not bool(out.any())


@pytest.mark.parametrize("exchange,dph,depth", [("a2a", None, 0), ("hier", 4, 0),
                                                ("a2a", None, 2)])
@pytest.mark.parametrize("budget", [32, 2])
def test_routed_chain_on_card_matches_cpu(card, exchange, dph, depth, budget):
    """A routed chain dispatched and harvested on the card equals the same
    chain on the CPU (counts, ids, levels, the final invalid state); with a
    budget of 2 levels a stage the stages overrun it and the harvest
    finishes them with host-read levels."""
    rng = np.random.default_rng(11)
    graphs = _routed_pair(card, exchange, dph, depth)
    # low ids: deep closures (edges run from lower to higher ids)
    stages = [rng.choice(300, size=3, replace=False).tolist() for _ in range(4)]
    got = []
    for g in graphs:
        g.chain_levels = budget
        g.run_wave_collect([5999])
        counts, ids, info = g.harvest_union_chain(g.dispatch_union_chain(stages))
        got.append((counts.tolist(), [sorted(i.tolist()) for i in ids],
                    info["levels"].tolist(), g.invalid_mask(), info["host_finished"],
                    g.stats()))
    (c0, i0, l0, m0, h0, s0), (c1, i1, l1, m1, h1, s1) = got
    assert c0 == c1 and i0 == i1 and l0 == l1 and np.array_equal(m0, m1) and h0 == h1
    assert s0 == s1
    assert (h0 > 0) == (budget == 2)


#: every lookup of the wide routed graph: (exchange, devices per host)
WIDE_LOOKUPS = [("a2a", None), ("tree", None), ("gather", None), ("hier", 4)]


@functools.lru_cache(maxsize=None)
def _wide_routed(exchange, dph):
    """A routed graph on the card wide enough that every shard spans many
    warp tiles and blocks: 200,000 nodes on 8 logical shards, ~75,000 live
    edge slots a shard; 1 node in 50 epoch-bumped (its in-edges are stale)."""
    from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap
    from stl_fusion_tpu_torch.parallel import RoutedShardedGraph

    n, card = 200_000, torch.device("cuda")
    src, dst = power_law_dag(n, avg_degree=3.0, seed=3)
    epoch = np.zeros(n, np.int32)
    epoch[np.random.default_rng(2).choice(n, n // 50, replace=False)] = 1
    pl = DevicePlacement.build(ShardMap.initial(["a", "b"], n_shards=32), 8, n,
                               devices_per_host=dph)
    return RoutedShardedGraph(src, dst, n, pl, mesh=graph_mesh(devices=[card] * 8),
                              exchange=exchange, edge_dst_epoch=np.zeros(len(dst), np.int32),
                              node_epoch=epoch, exchange_async=True, async_depth=1)


def _relayout(g, e_cap, n_edges):
    """``g``'s edge arrays re-sliced at ``e_cap`` slots a shard, shard ``d``
    keeping its first ``n_edges[d]`` edges live: a layout the graph would
    not build (``e_cap`` not a multiple of 4, a shard with no live edge,
    shards of very different lengths), for the kernel to take."""
    from stl_fusion_tpu_torch.ops import routed_wave as rw

    L0, old = g._wave.layout, g.e_cap
    assert all(k <= min(c, e_cap) for k, c in zip(n_edges, g._dev_edge_count))
    cols = []
    for name, pad in (("_h_eprod", 0), ("_h_ebslot", 0), ("_h_ebit", 0),
                      ("_h_edst", g.n_local), ("_h_elsrc", g.n_local), ("_h_eep", -1)):
        a = np.full((g.n_dev, e_cap), pad, np.int32)
        k = min(old, e_cap)
        a[:, :k] = getattr(g, name).reshape(g.n_dev, old)[:, :k]
        cols.append(torch.from_numpy(a.reshape(-1)).to(L0.eprod.device))
    return rw.RoutedEdges(*cols, torch.tensor(n_edges, dtype=torch.int32,
                                              device=L0.eprod.device),
                          max(n_edges), e_cap, L0.n_local, g.n_dev, L0.mode, L0.icap, L0.hcap,
                          L0.dph, L0.n_hosts)


def _wide_level_matches_plain(g, L, spec, seed=7):
    """One ``routed_level`` launch on layout ``L`` of ``g`` against the
    plain version from the same frontier (30 % of the rows) and invalid
    state (~25 % of the bits): ``invalid``, ``next``, ``acc`` and every
    ``out`` entry equal. Then ``go`` = 0 changes nothing and ``go`` = 5
    runs the level. Returns the kernel's ``out``."""
    from stl_fusion_tpu_torch.ops import routed_wave as rw

    card = L.eprod.device
    rng = np.random.default_rng(seed)
    f = g._words_of_rows(g.perm[rng.choice(g.n_nodes, g.n_nodes * 3 // 10, replace=False)])
    inv0 = torch.from_numpy(rng.integers(-(2**31), 2**31, g.n_words, dtype=np.int32)
                            & rng.integers(-(2**31), 2**31, g.n_words, dtype=np.int32)).to(card)
    w = g._wave
    x, stride, cross = (f, g.w_local, None) if spec else w.exchange(f)

    def level(fn, go=None):
        inv, nxt, acc = inv0.clone(), torch.zeros_like(f), f.clone()
        out = torch.zeros(rw.slot_width(g.n_dev), dtype=torch.int64, device=card)
        fn(x, stride, cross, L, w.nepoch, inv, nxt, out, go=go, acc=acc, spec=spec)
        torch.cuda.synchronize()
        return inv, nxt, acc, out

    before = rw.launches
    got, want = level(rw.routed_level), level(rw.routed_level_plain)
    assert rw.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    zero = torch.zeros((), dtype=torch.int64, device=card)
    inv, nxt, acc, out = level(rw.routed_level, go=zero)
    assert torch.equal(inv, inv0) and torch.equal(acc, f) and not bool(nxt.any())
    assert not bool(out.any())
    for a, b in zip(level(rw.routed_level, go=zero + 5), want):
        assert torch.equal(a, b)
    return got[3].cpu().numpy()


@pytest.mark.parametrize("exchange,dph", WIDE_LOOKUPS)
@pytest.mark.parametrize("form", ["level", "spec"])
def test_routed_level_wide_graph_matches_plain(card, exchange, dph, form):
    """Every lookup and the speculative form on the graph's own layout,
    every shard spanning hundreds of warp tiles: exact, every shard lit."""
    g = _wide_routed(exchange, dph)
    out = _wide_level_matches_plain(g, g._wave.layout, form == "spec")
    assert (out[: g.n_dev] > 0).all() and out[g.n_dev] == out[: g.n_dev].sum()


@pytest.mark.parametrize("exchange,dph", [("a2a", None), ("hier", 4), ("gather", None)])
@pytest.mark.parametrize("pad", [1, 2, 3])
@pytest.mark.parametrize("form", ["level", "spec"])
def test_routed_level_odd_layouts_match_plain(card, exchange, dph, pad, form):
    """``e_cap`` not a multiple of 4 (every shard's first slot off a 16-byte
    boundary but shard 0's), shard 1 with no live edge, and shards of very
    different lengths (all, 37, 1,000, 5, a third, 129 and 4 slots): exact,
    and the empty shard counts 0."""
    g = _wide_routed(exchange, dph)
    full = g._dev_edge_count
    n_edges = [int(full[0]), 0, 37, 1000, 5, int(full[5]) // 3, 129, 4]
    L = _relayout(g, -(-g.e_cap // 4) * 4 + pad, n_edges)
    assert L.e_cap % 4 != 0
    out = _wide_level_matches_plain(g, L, form == "spec", seed=pad)
    assert out[1] == 0 and out[0] > 0


def _seed_inputs(card, n_dev, w_local, seed):
    """Seed words over ``n_dev`` shards of ``w_local`` words (held as row 1
    of a buffer whose rows are ``n + 1`` words, so the row starts off a
    16-byte boundary as a chain stage's seeds do) and invalid words: sparse
    seeds, one word of all 32 bits, seeds already invalid, shard 2's seeds
    all already invalid."""
    rng = np.random.default_rng(seed)
    n = n_dev * w_local
    s = np.zeros(n, np.uint32)
    at = rng.choice(n, n // 40, replace=False)
    s[at] = np.uint32(1) << rng.integers(0, 32, len(at)).astype(np.uint32)
    s[5] = 0xFFFFFFFF
    inv = np.where(rng.random(n) < 0.3, rng.integers(0, 2**32, n, dtype=np.uint64), 0)
    inv = inv.astype(np.uint32)
    inv[at[: len(at) // 3]] |= s[at[: len(at) // 3]]  # seeds already invalid
    sh2 = slice(2 * w_local, 3 * w_local)
    inv[sh2] |= s[sh2]
    buf = torch.zeros((2, n + 1), dtype=torch.int32, device=card)
    buf[1, :n] = torch.from_numpy(s.view(np.int32)).to(card)
    return buf[1, :n], torch.from_numpy(inv.view(np.int32)).to(card)


def _seed_both(seeds, inv0, n_dev, w_local, chain=None):
    from stl_fusion_tpu_torch.ops import routed_wave as rw

    res = []
    for fn in (rw.routed_seed, rw.routed_seed_plain):
        inv = inv0.clone()
        out = torch.zeros(rw.slot_width(n_dev), dtype=torch.int64, device=inv0.device)
        ch = None if chain is None else tuple(t.clone() for t in chain)
        fn(seeds, inv, out, n_dev, w_local, ch)
        torch.cuda.synchronize()
        res.append((inv, out) + (() if ch is None else (ch[2],)))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    return res[0]


@pytest.mark.parametrize("w_local", [60_001, 3])
def test_routed_seed_kernel_matches_plain(card, w_local):
    """The seed step against its plain version over 8 shards (60,001 words
    each: many blocks, and shards that meet inside an int4; 3 words each:
    only the head and tail words), from a row off a 16-byte boundary: the
    invalid words and every ``out`` entry equal; a word of all 32 bits,
    seeds already invalid (they conduct and do not count) and shard 2 with
    no fresh seed."""
    seeds, inv0 = _seed_inputs(card, 8, w_local, seed=w_local)
    inv, out = _seed_both(seeds, inv0, 8, w_local)
    out = out.cpu().numpy()
    assert out[9] == 1 and out[8] == out[:8].sum() > 0
    if w_local > 3:
        assert out[2] == 0 and (np.delete(out[:8], 2) > 0).all()
    # the any-seed flag with no fresh seed: every seed already invalid
    inv, out = _seed_both(seeds, inv0 | seeds, 8, w_local)
    assert torch.equal(inv, inv0 | seeds) and out[9] == 1 and not bool(out[:9].any())
    # no seed at all
    inv, out = _seed_both(torch.zeros_like(seeds), inv0, 8, w_local)
    assert torch.equal(inv, inv0) and not bool(out.any())


@pytest.mark.parametrize("prev_last,prev_broken", [(0, 0), (3, 0), (0, 1), (7, 1)])
def test_routed_seed_chain_skip_matches_plain(card, prev_last, prev_broken):
    """In a chain the seed step runs only after a stage that ran and
    quiesced; else it changes nothing and marks its own stage broken."""
    seeds, inv0 = _seed_inputs(card, 8, 1001, seed=1)
    chain = (torch.tensor(prev_last, dtype=torch.int64, device=card),
             torch.tensor(prev_broken, dtype=torch.int32, device=card),
             torch.zeros((), dtype=torch.int32, device=card))
    inv, out, broken = _seed_both(seeds, inv0, 8, 1001, chain)
    skip = prev_last != 0 or prev_broken != 0
    assert int(broken) == int(skip)
    assert torch.equal(inv, inv0) == skip and bool(out.any()) != skip
