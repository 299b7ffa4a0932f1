"""Parity of the port's hub backend with the JAX package's: the same
services run on a JAX-backed hub and on a port-backed hub (``device="cpu"``),
and the two-tier application (watched nodes eager, the rest pending), the
batch cascade, recompute after a wave and the journal's ordering must agree
exactly (node states, counts, and the mirrored invalid masks)."""
import torch_threads  # noqa: F401 — one torch thread a test process
import numpy as np
import pytest

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph


def _world(core, graph, **backend_kw):
    """A hub + backend + HelloCart-shaped services built from one package."""

    class Products(core.ComputeService):
        def __init__(self, hub):
            super().__init__(hub)
            self.price = {"apple": 2.0, "banana": 0.5, "cherry": 4.0}

        @core.compute_method
        async def get(self, pid: str) -> float:
            return self.price[pid]

    class Carts(core.ComputeService):
        def __init__(self, hub, products):
            super().__init__(hub)
            self.products = products
            self.items = {"alice": ("apple", "apple", "banana"), "bob": ("cherry",)}

        @core.compute_method
        async def total(self, cart: str) -> float:
            return sum([await self.products.get(p) for p in self.items[cart]])

        @core.compute_method
        async def grand_total(self) -> float:
            return await self.total("alice") + await self.total("bob")

    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, **backend_kw)
    products = Products(hub)
    return hub, backend, products, Carts(hub, products)


WORLDS = [(jcore, jgraph, {}), (pcore, pgraph, {"device": "cpu"})]


async def _scenario(core, graph, kw):
    """Drive one world; return everything the two worlds must agree on."""
    hub, backend, products, carts = _world(core, graph, **kw)
    out = {"grand": await carts.grand_total()}
    c_apple = await core.capture(lambda: products.get("apple"))
    c_alice = await core.capture(lambda: carts.total("alice"))
    c_bob = await core.capture(lambda: carts.total("bob"))
    c_grand = await core.capture(lambda: carts.grand_total())
    fired = []
    c_grand.on_invalidated(lambda c: fired.append("grand"))  # → watched

    products.price["apple"] = 3.0
    out["cascade"] = backend.invalidate_cascade(c_apple)
    out["fired"] = list(fired)
    out["states"] = [int(c._state) for c in (c_apple, c_alice, c_bob, c_grand)]
    out["is_invalidated"] = [c.is_invalidated for c in (c_apple, c_alice, c_bob, c_grand)]
    out["pending"] = backend._pending[: backend.node_count].copy()
    out["grand2"] = await carts.grand_total()
    out["alice_state_after_read"] = int(c_alice._state)  # materialized by the bump

    # batch cascade: two seeds, one union wave
    c_banana = await core.capture(lambda: products.get("banana"))
    c_cherry = await core.capture(lambda: products.get("cherry"))
    products.price["cherry"] = 1.0
    out["batch"] = backend.invalidate_cascade_batch([c_banana, c_cherry])
    out["grand3"] = await carts.grand_total()

    # journal ordering: a host-led mark buffered BEFORE a recompute's bump
    # dies with the bump — the recomputed node cascades again afterwards
    c_bob2 = await core.capture(lambda: carts.total("bob"))
    c_bob2.invalidate()  # journals ("invalid", bob)
    await carts.total("bob")  # recompute journals ("bump", bob)
    await carts.grand_total()
    backend.flush()
    nid_bob = backend.id_for(await core.capture(lambda: carts.total("bob")))
    out["bob_device_invalid_after_flush"] = bool(backend.graph.invalid_mask()[nid_bob])
    c_cherry2 = await core.capture(lambda: products.get("cherry"))
    out["cascade_after_bump"] = backend.invalidate_cascade(c_cherry2)
    out["grand4"] = await carts.grand_total()

    # a host-led change through the public idiom: the host cascades, the
    # mirror receives the marks at the next flush
    products.price["banana"] = 2.5
    with core.invalidating():
        await products.get("banana")
    backend.flush()
    out["grand5"] = await carts.grand_total()
    out["mask"] = backend.graph.invalid_mask().copy()
    out["counts"] = (backend.waves_run, backend.device_invalidations,
                     backend.node_count, backend.edge_count)
    return out


async def test_backend_matches_jax_end_to_end():
    jax_out = await _scenario(*WORLDS[0])
    port_out = await _scenario(*WORLDS[1])
    assert port_out.keys() == jax_out.keys()
    for key in jax_out:
        if isinstance(jax_out[key], np.ndarray):
            np.testing.assert_array_equal(port_out[key], jax_out[key], err_msg=key)
        else:
            assert port_out[key] == jax_out[key], key
    # spot-check the semantics the two agree on
    assert port_out["fired"] == ["grand"]
    assert port_out["grand"] == 8.5 and port_out["grand2"] == 10.5
    assert port_out["bob_device_invalid_after_flush"] is False
    assert port_out["cascade_after_bump"] == 3  # cherry → bob → grand
    assert port_out["grand5"] == 3.0 + 3.0 + 2.5 + 1.0


@pytest.mark.parametrize("world", [0, 1], ids=["jax", "port"])
async def test_two_tier_application(world):
    core, graph, kw = WORLDS[world]
    hub, backend, products, carts = _world(core, graph, **kw)
    await carts.grand_total()
    c_apple = await core.capture(lambda: products.get("apple"))
    c_alice = await core.capture(lambda: carts.total("alice"))
    c_grand = await core.capture(lambda: carts.grand_total())
    c_grand.on_invalidated(lambda c: None)
    assert backend.invalidate_cascade(c_apple) == 3
    # watched: materialized eagerly; unwatched: pending, raw state untouched
    assert c_grand._state == int(core.ConsistencyState.INVALIDATED)
    assert c_alice._state == int(core.ConsistencyState.CONSISTENT)
    assert c_alice.is_invalidated and not c_alice.is_consistent
    assert backend._pending[backend.id_for(c_alice)]


def test_backend_later_slices_raise():
    hub = pcore.FusionHub()
    backend = pgraph.TpuGraphBackend(hub, device="cpu")
    # the resident live loop (A.5) is ported: the pipeline attaches, and the
    # chain and the super-rounds check their table contract
    pipe = hub.enable_nonblocking()
    assert backend.pipeline is pipe and hub.wave_pipeline is pipe
    assert backend.super_rounds is None and not backend.mesh_routing_active()
    # the watchdog (A.8) is ported: it attaches and routes the bursts
    from stl_fusion_tpu_torch.resilience import WaveWatchdog

    wd = WaveWatchdog()
    assert backend.attach_watchdog(wd) is wd and backend.watchdog is wd
    # the packed mesh mirror (A.9's first part) is ported: one shard on the
    # backend's device by default
    entry = backend.packed_mirror()
    assert entry["graph"].mesh.size == 1 and entry["graph"].in_src.device.type == "cpu"
    assert backend.packed_mirror() is entry
    # the routed mesh mirror (A.9's second part) is ported: routing turns
    # on, and the mirror builds lazily on the first routed wave
    from stl_fusion_tpu_torch.cluster import ShardMap

    backend.enable_mesh_routing(ShardMap.initial(["m0"], n_shards=8))
    assert backend.mesh_routing_active() and backend._routed_mirror is None
    assert pgraph.GraphBackend is pgraph.TpuGraphBackend
