"""Parity of the port's hot-key sketches (``stl_fusion_tpu_torch/diagnostics/
hotkeys.py``, which the RPC fan-out's mask drain feeds) with the JAX
package's: the 13 cases of ``tests/test_hotkeys.py``, each run as one
scenario through both packages on the same seeded stream of offers, with the
reference's assertions held on both and the observations (estimates, error
bounds, top-k lists, wire payloads, metric samples) required EQUAL. The
reference's three mesh cases run the board half of the exchange: a remote
host's ``payload()`` folded in with ``merge_payloads`` and
``report(extra_payloads=...)``, as ``MeshTelemetryAggregator`` does (the
aggregator itself is ROADMAP A.8); the staleness case leaves the stale
host's payload out of the fold, which is what the aggregator's horizon
does. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import json

import numpy as np
import pytest

import stl_fusion_tpu.diagnostics.hotkeys as jhot
import stl_fusion_tpu.diagnostics.metrics as jmetrics
import stl_fusion_tpu_torch.diagnostics.hotkeys as phot
import stl_fusion_tpu_torch.diagnostics.metrics as pmetrics

PKGS = {"jax": (jhot, jmetrics), "port": (phot, pmetrics)}


def both(scenario):
    """``scenario(hotkeys, metrics)`` through each package; EQUAL results."""
    got = [scenario(*mods) for mods in PKGS.values()]
    assert got[0] == got[1], got
    return got[1]


def stream(seed, n, keys, max_n=3):
    """A seeded stream of (key, count) offers."""
    rng = np.random.default_rng(seed)
    return [(f"k{int(k)}", int(c)) for k, c in zip(rng.zipf(1.3, n) % keys,
                                                     rng.integers(1, max_n + 1, n))]


def test_exact_when_under_capacity():
    def run(hot, _m):
        sk = hot.SpaceSavingSketch(capacity=8)
        for key, n in [("a", 5), ("b", 3), ("c", 1)]:
            sk.offer(key, n)
        assert sk.estimate("a") == 5 and sk.error_of("a") == 0
        assert sk.total == 9
        top = sk.topk(2)
        assert [(e["key"], e["count"]) for e in top] == [("a", 5), ("b", 3)]
        assert top[0]["share"] == round(5 / 9, 6)
        return top, sk.to_payload()
    both(run)


def test_eviction_inherits_count_and_never_understates():
    def run(hot, _m):
        sk = hot.SpaceSavingSketch(capacity=2)
        sk.offer("a", 10)
        sk.offer("b", 1)
        sk.offer("c", 1)  # evicts b at count 1
        assert sk.estimate("c") == 2 and sk.error_of("c") == 1
        assert sk.estimate("b") == 0 and len(sk) == 2
        return sk.to_payload()
    both(run)


def test_deterministic_eviction_ties_break_by_key():
    def run(hot, _m):
        a, b = hot.SpaceSavingSketch(capacity=2), hot.SpaceSavingSketch(capacity=2)
        for sk in (a, b):
            for key in ("x", "y", "z"):
                sk.offer(key, 1)
        assert a.to_payload() == b.to_payload()
        assert a.estimate("y") == 1 and a.estimate("x") == 0
        return a.to_payload()
    both(run)


def test_memory_stays_bounded_under_many_distinct_keys():
    def run(hot, _m):
        sk = hot.SpaceSavingSketch(capacity=16)
        for i in range(1_000_000):
            sk.offer(f"k{i}")
        assert len(sk) == 16 and len(sk._heap) <= 4 * 16
        assert sk.total == 1_000_000
        assert len(sk._counts) == 16 and len(sk._errors) == 16
        return sk.to_payload()
    both(run)


def test_heavy_hitters_survive_a_long_tail():
    def run(hot, _m):
        sk = hot.SpaceSavingSketch(capacity=32)
        for i in range(20_000):
            sk.offer(f"tail{i}")
            if i % 4 == 0:
                sk.offer("hot", 2)
        top = sk.topk(1)[0]
        assert top["key"] == "hot" and top["count"] >= 10_000
        return sk.topk(8)
    both(run)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_is_commutative_and_deterministic(seed):
    def run(hot, _m):
        a, b = hot.SpaceSavingSketch(capacity=8), hot.SpaceSavingSketch(capacity=8)
        for key, n in stream(seed, 400, 40):
            a.offer(key, n)
        for key, n in stream(seed + 10, 400, 25):
            b.offer("b" + key, n)
            a.offer("shared", 1)
            b.offer("shared", 2)
        ab, ba = a.merge(b), b.merge(a)
        assert ab.to_payload() == ba.to_payload()
        assert ab.total == a.total + b.total
        assert ab.estimate("shared") == a.estimate("shared") + b.estimate("shared")
        return ab.to_payload()
    both(run)


def test_payload_roundtrip_is_exact_and_json_safe():
    def run(hot, _m):
        sk = hot.SpaceSavingSketch(capacity=4)
        for key, n in stream(3, 300, 12):
            sk.offer(key, n)
        wire = json.loads(json.dumps(sk.to_payload()))
        back = hot.SpaceSavingSketch.from_payload(wire)
        assert back.to_payload() == sk.to_payload()
        wire["entries"].append(["ok-key", "not-a-count", None])
        patched = hot.SpaceSavingSketch.from_payload(wire)
        assert patched.estimate("ok-key") == 0
        assert patched.to_payload()["entries"] == sk.to_payload()["entries"]
        return wire
    both(run)


def test_board_domains_and_share_of():
    def run(hot, metrics):
        board = hot.HotKeyBoard(capacity=8, registry=metrics.MetricsRegistry())
        for domain in hot.HOTKEY_DOMAINS[:2]:
            board.offer(domain, "k1", 3)
            board.offer(domain, "k2", 1)
        assert board.domains() == sorted(hot.HOTKEY_DOMAINS[:2])
        share = board.share_of(hot.HOTKEY_DOMAINS[0], "k1")
        assert share["rank"] == 1 and share["count"] == 3 and share["share"] == 0.75
        assert board.share_of(hot.HOTKEY_DOMAINS[0], "missing") is None
        assert board.share_of("never_offered", "k1") is None
        return hot.HOTKEY_DOMAINS, share, board.payload()
    both(run)


def test_board_collector_exports_offer_counters():
    def run(hot, metrics):
        reg = metrics.MetricsRegistry()
        board = hot.HotKeyBoard(capacity=8, registry=reg)
        board.offer("edge_deliveries", "k", 5)
        flat = reg.flat_samples()
        assert flat['fusion_hotkey_offers_total{domain="edge_deliveries"}'] == 5
        assert flat['fusion_hotkey_tracked{domain="edge_deliveries"}'] == 1
        return {k: v for k, v in flat.items() if "hotkey" in k}
    both(run)


def _two_host_boards(hot, metrics):
    """Two hosts' boards on their own registries, fed the reference's
    streams; h1's payload is what rides its mesh snapshot."""
    board0 = hot.HotKeyBoard(capacity=8, registry=metrics.MetricsRegistry())
    board1 = hot.HotKeyBoard(capacity=8, registry=metrics.MetricsRegistry())
    for i in range(40):
        board0.offer("edge_deliveries", f"k{i % 5}")
        board1.offer("edge_deliveries", f"k{i % 3}", 2)
    board1.offer("tenant_sheds", "t-noisy", 9)
    return board0, board1


def test_mesh_snapshot_merge_is_order_independent():
    def run(hot, metrics):
        board0, board1 = _two_host_boards(hot, metrics)
        payload = json.loads(json.dumps(board1.payload()))  # over the wire
        merged = hot.HotKeyBoard.merge_payloads([board0.payload(), payload])
        reverse = hot.HotKeyBoard.merge_payloads([payload, board0.payload()])
        direct_ab = board0.sketch("edge_deliveries").merge(board1.sketch("edge_deliveries"))
        direct_ba = board1.sketch("edge_deliveries").merge(board0.sketch("edge_deliveries"))
        assert merged["edge_deliveries"].to_payload() == direct_ab.to_payload()
        assert reverse["edge_deliveries"].to_payload() == direct_ab.to_payload()
        assert direct_ab.to_payload() == direct_ba.to_payload()
        assert merged["tenant_sheds"].estimate("t-noisy") == 9
        return {d: sk.to_payload() for d, sk in merged.items()}
    both(run)


def test_mesh_hotkeys_report_shape():
    def run(hot, metrics):
        board0, board1 = _two_host_boards(hot, metrics)
        report = board0.report(n=2, extra_payloads=[board1.payload()])
        deliveries = report["edge_deliveries"]
        assert deliveries["total"] == 40 + 80 and len(deliveries["top"]) == 2
        json.dumps(report)
        return report
    both(run)


def test_stale_host_sketches_are_excluded():
    def run(hot, metrics):
        board0, board1 = _two_host_boards(hot, metrics)
        fresh = hot.HotKeyBoard.merge_payloads([board0.payload(), board1.payload()])
        assert fresh["edge_deliveries"].total == 120
        local = hot.HotKeyBoard.merge_payloads([board0.payload()])  # h1 past the horizon
        assert local["edge_deliveries"].total == 40 and "tenant_sheds" not in local
        return board0.report(n=3), {d: sk.to_payload() for d, sk in fresh.items()}
    both(run)


def test_merge_payload_fold_matches_pairwise_any_order():
    def run(hot, _m):
        sketches = []
        for seed in range(3):
            sk = hot.SpaceSavingSketch(capacity=16)
            for i in range(60):
                sk.offer(f"k{(i * (seed + 3)) % 9}")
            sketches.append(sk)
        payloads = [{"d": sk.to_payload()} for sk in sketches]
        forward = hot.HotKeyBoard.merge_payloads(payloads)["d"]
        backward = hot.HotKeyBoard.merge_payloads(payloads[::-1])["d"]
        assert forward.total == backward.total == 180
        assert forward.to_payload() == backward.to_payload()
        return forward.to_payload()
    both(run)
