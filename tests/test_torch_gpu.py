"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the card, and the dense and sharded wave paths on
the card against the same paths on the CPU. Tolerance: exact (integer words, bits and
counts). This file imports torch and the port only — no JAX — so it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Elsewhere every test skips with its reason."""
import numpy as np
import pytest
import torch

from stl_fusion_tpu_torch.graph import DeviceGraph
from stl_fusion_tpu_torch.graph.synthetic import power_law_dag
from stl_fusion_tpu_torch.ops import or_popcount as opc
from stl_fusion_tpu_torch.ops import ring_all_gather as rag
from stl_fusion_tpu_torch.ops import wave as tw
from stl_fusion_tpu_torch.ops.bitops import pack_bits
from stl_fusion_tpu_torch.parallel import ShardedDeviceGraph, graph_mesh

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


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("chunk", [1, 31, 128, 39063])
def test_ring_all_gather_kernel_matches_plain(card, n_shards, chunk):
    rng = np.random.default_rng(1000 * n_shards + chunk)
    chunks = [torch.from_numpy(rng.integers(-(2**31), 2**31, size=chunk, dtype=np.int32)).to(card)
              for _ in range(n_shards)]
    want = rag.ring_all_gather_plain(chunks)
    before = rag.launches
    got = rag.ring_all_gather(chunks)
    torch.cuda.synchronize()
    assert rag.launches == before + 1
    full = torch.cat(chunks)
    for d in range(n_shards):
        assert torch.equal(got[d], want[d]) and torch.equal(got[d], full), f"shard {d}"


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
