"""Parity of the port's computed core (``stl_fusion_tpu_torch/core``) with
the JAX package's: the 24 cases of ``tests/test_core.py`` (memoization,
call-shape normalization, dependency capture and cascades, errors, single
flight, keep-alive and collection, change streams, anonymous sources,
invalidation delay, the hot path), each run as one scenario through both
packages under a fresh default hub, with the reference's assertions, and
their observations (values read, compute counts, consistency flags)
required EQUAL. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import gc

import pytest

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.core.inputs as jinputs
import stl_fusion_tpu.utils.serialization as jser
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.core.inputs as pinputs
import stl_fusion_tpu_torch.utils.serialization as pser

PKGS = {"jax": (jcore, jinputs, jser), "port": (pcore, pinputs, pser)}


async def both(scenario):
    """Run ``scenario(core, inputs, ser, hub)`` on each package under a
    fresh default hub; the observations must be equal."""
    got = []
    for core, inputs, ser in PKGS.values():
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            got.append(await scenario(core, inputs, ser, hub))
        finally:
            core.set_default_hub(old)
    assert got[0] == got[1], got
    return got[1]


def counter_service(core):
    class CounterService(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self.counters = {}
            self.compute_count = 0

        @core.compute_method
        async def get(self, key: str) -> int:
            self.compute_count += 1
            return self.counters.get(key, 0)

        @core.compute_method
        async def sum2(self, a: str, b: str) -> int:
            return await self.get(a) + await self.get(b)

        async def increment(self, key: str):
            self.counters[key] = self.counters.get(key, 0) + 1
            with core.invalidating():
                await self.get(key)

    return CounterService


# ------------------------------------------------------------------ memoization

async def test_memoization_hit():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        seen = [await svc.get("a"), await svc.get("a"), svc.compute_count]
        seen += [await svc.get("b"), svc.compute_count]
        assert seen == [0, 0, 1, 0, 2]
        return seen
    await both(run)


async def test_kwargs_normalize_to_same_key():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        await svc.get("a")
        await svc.get(key="a")
        assert svc.compute_count == 1
        return svc.compute_count
    await both(run)


async def test_defaulted_call_shapes_share_one_node():
    async def run(core, inputs, ser, hub):
        class Defaulted(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.calls = 0

            @core.compute_method
            async def get(self, a: str, b: int = 3) -> int:
                self.calls += 1
                return len(a) + b

        svc = Defaulted()
        seen = [await svc.get("x"), await svc.get("x", 3), await svc.get("x", b=3),
                await svc.get(a="x"), svc.calls]
        assert seen == [4, 4, 4, 4, 1]
        with core.invalidating():
            await svc.get("x", 3)
        seen += [await svc.get("x"), svc.calls]
        for _ in range(3):
            await svc.get("x")
        seen.append(svc.calls)
        assert seen[-3:] == [4, 2, 2]
        return seen
    await both(run)


async def test_keyword_only_methods_replay_and_share_nodes():
    async def run(core, inputs, ser, hub):
        class KwOnly(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.calls = 0

            @core.compute_method
            async def get(self, a: str, *, b: int = 3) -> int:
                self.calls += 1
                return len(a) + b

        svc = KwOnly()
        seen = [await svc.get("x", b=3), await svc.get("x"), await svc.get(a="x", b=3),
                svc.calls, await svc.get("x", b=5), svc.calls]
        assert seen == [4, 4, 4, 1, 6, 2]
        with core.invalidating():
            await svc.get("x")
        seen += [await svc.get("x", b=3), svc.calls]
        assert seen[-2:] == [4, 3]
        return seen
    await both(run)


async def test_unhashable_default_keeps_raw_identity():
    async def run(core, inputs, ser, hub):
        class Mutable(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.calls = 0

            @core.compute_method
            async def get(self, a: str, extra: list = []) -> int:  # noqa: B006
                self.calls += 1
                return len(a) + len(extra)

        svc = Mutable()
        seen = [await svc.get("x"), await svc.get("x"), svc.calls]
        assert seen == [1, 1, 1]
        return seen
    await both(run)


async def test_kwargs_tail_wire_roundtrip_stays_hashable():
    async def run(core, inputs, ser, hub):
        tail = inputs.KwArgsTail((("ids", (1, (2, 3))), ("name", "x")))
        wire = ser.encode(tail)
        back = ser.decode(wire)
        assert back == tail
        hash(back)
        return wire, repr(back)
    await both(run)


async def test_invalidation_recomputes():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        seen = [await svc.get("a")]
        await svc.increment("a")
        seen += [await svc.get("a"), svc.compute_count]
        assert seen == [0, 1, 2]
        return seen
    await both(run)


# ------------------------------------------------------------------ dependency capture

async def test_cascading_invalidation_through_dependency():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        seen = [await svc.sum2("x", "y")]
        c_sum = await core.get_existing(lambda: svc.sum2("x", "y"))
        assert c_sum is not None and c_sum.is_consistent
        seen.append(len(c_sum.used))
        await svc.increment("x")
        seen += [c_sum.is_invalidated, await svc.sum2("x", "y")]
        assert seen == [0, 2, True, 1]
        return seen
    await both(run)


async def test_version_mismatched_edge_does_not_invalidate():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        await svc.sum2("x", "y")
        old_sum = await core.get_existing(lambda: svc.sum2("x", "y"))
        await svc.increment("x")
        assert old_sum.is_invalidated
        new_val = await svc.sum2("x", "y")
        new_sum = await core.get_existing(lambda: svc.sum2("x", "y"))
        assert new_sum is not old_sum and new_sum.is_consistent
        assert new_val == 1
        return new_val, old_sum.is_invalidated, new_sum.is_consistent
    await both(run)


async def test_capture_returns_computed():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        c = await core.capture(lambda: svc.get("a"))
        assert c.is_consistent and c.value == 0
        c2 = await core.capture(lambda: svc.get("a"))
        assert c2 is c
        return c.value, c2 is c
    await both(run)


async def test_get_existing_peeks_without_compute():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        seen = [await core.get_existing(lambda: svc.get("a")) is None, svc.compute_count]
        await svc.get("a")
        existing = await core.get_existing(lambda: svc.get("a"))
        seen += [existing is not None and existing.value == 0, svc.compute_count]
        assert seen == [True, 0, True, 1]
        return seen
    await both(run)


async def test_is_invalidating_scope():
    async def run(core, inputs, ser, hub):
        seen = [core.is_invalidating()]
        with core.invalidating():
            seen.append(core.is_invalidating())
        seen.append(core.is_invalidating())
        assert seen == [False, True, False]
        return seen
    await both(run)


# ------------------------------------------------------------------ errors

def failing_service(core):
    class FailingService(core.ComputeService):
        def __init__(self):
            super().__init__()
            self.calls = 0
            self.should_fail = True

        @core.compute_method(transient_error_invalidation_delay=float("inf"))
        async def get(self) -> int:
            self.calls += 1
            if self.should_fail:
                raise ValueError("nope")
            return 42

    return FailingService


async def test_errors_are_memoized():
    async def run(core, inputs, ser, hub):
        svc = failing_service(core)()
        with pytest.raises(ValueError):
            await svc.get()
        with pytest.raises(ValueError):
            await svc.get()
        assert svc.calls == 1
        c = await core.try_capture(lambda: svc.get())
        assert c is not None and c.output.has_error
        svc.should_fail = False
        c.invalidate(immediately=True)
        value = await svc.get()
        assert value == 42
        return svc.calls, value
    await both(run)


async def test_transient_error_self_heals():
    async def run(core, inputs, ser, hub):
        class S(core.ComputeService):
            calls = 0

            @core.compute_method(transient_error_invalidation_delay=0.02)
            async def get(self) -> int:
                S.calls += 1
                if S.calls == 1:
                    raise RuntimeError("transient")
                return 7

        svc = S()
        with pytest.raises(RuntimeError):
            await svc.get()
        await asyncio.sleep(0.15)
        value = await svc.get()
        assert value == 7
        return value
    await both(run)


# ------------------------------------------------------------------ single flight

async def test_concurrent_calls_compute_once():
    async def run(core, inputs, ser, hub):
        class Slow(core.ComputeService):
            calls = 0

            @core.compute_method
            async def get(self, k: str) -> str:
                Slow.calls += 1
                await asyncio.sleep(0.02)
                return k * 2

        svc = Slow()
        results = await asyncio.gather(*(svc.get("z") for _ in range(20)))
        assert all(r == "zz" for r in results) and Slow.calls == 1
        return results, Slow.calls
    await both(run)


async def test_invalidate_while_computing_defers():
    async def run(core, inputs, ser, hub):
        started = asyncio.Event()
        release = asyncio.Event()

        class Slow(core.ComputeService):
            @core.compute_method
            async def get(self) -> int:
                started.set()
                await release.wait()
                return 1

        svc = Slow()
        task = asyncio.ensure_future(svc.get())
        await started.wait()
        existing = await core.get_existing(lambda: svc.get())
        assert existing is not None
        state = existing.consistency_state
        assert state == core.ConsistencyState.COMPUTING
        existing.invalidate(immediately=True)
        release.set()
        value = await task
        assert value == 1 and existing.is_invalidated
        return int(state), value, existing.is_invalidated
    await both(run)


# ------------------------------------------------------------------ GC / keep-alive

async def test_unreferenced_node_is_collected():
    async def run(core, inputs, ser, hub):
        class Weak(core.ComputeService):
            @core.compute_method(min_cache_duration=0.0)
            async def get(self, k: str) -> int:
                return 0

        svc = Weak()
        await svc.get("gc-me")
        gc.collect()
        gone = await core.get_existing(lambda: svc.get("gc-me")) is None
        assert gone
        return gone
    await both(run)


async def test_min_cache_duration_keeps_alive():
    async def run(core, inputs, ser, hub):
        class Cached(core.ComputeService):
            calls = 0

            @core.compute_method(min_cache_duration=30.0)
            async def get(self) -> int:
                Cached.calls += 1
                return 5

        svc = Cached()
        await svc.get()
        gc.collect()
        kept = await core.get_existing(lambda: svc.get()) is not None
        value = await svc.get()
        assert kept and value == 5 and Cached.calls == 1
        return kept, value, Cached.calls
    await both(run)


async def test_dependents_keep_dependencies_alive():
    async def run(core, inputs, ser, hub):
        class Weak(core.ComputeService):
            @core.compute_method(min_cache_duration=0.0)
            async def get(self, k: str) -> int:
                return 1

            @core.compute_method(min_cache_duration=0.0)
            async def sum2(self, a: str, b: str) -> int:
                return await self.get(a) + await self.get(b)

        svc = Weak()
        c_sum = await core.capture(lambda: svc.sum2("p", "q"))
        gc.collect()
        held = await core.get_existing(lambda: svc.get("p")) is not None
        del c_sum
        gc.collect()
        gone = await core.get_existing(lambda: svc.get("p")) is None
        assert held and gone
        return held, gone
    await both(run)


# ------------------------------------------------------------------ when/changes

async def test_when_invalidated_and_changes():
    async def run(core, inputs, ser, hub):
        svc = counter_service(core)()
        c = await core.capture(lambda: svc.get("w"))
        fut = c.when_invalidated()
        assert not fut.done()
        await svc.increment("w")
        await asyncio.wait_for(fut, 1.0)
        seen = []

        async def watcher():
            c0 = await core.capture(lambda: svc.get("w"))
            async for snapshot in c0.changes():
                seen.append(snapshot.value)
                if snapshot.value >= 3:
                    return

        task = asyncio.ensure_future(watcher())
        await asyncio.sleep(0.01)
        await svc.increment("w")
        await asyncio.sleep(0.01)
        await svc.increment("w")
        await asyncio.wait_for(task, 2.0)
        assert seen == [1, 2, 3]
        return seen
    await both(run)


# ------------------------------------------------------------------ anonymous source

async def test_anonymous_computed_source():
    async def run(core, inputs, ser, hub):
        calls = 0

        async def compute(source):
            nonlocal calls
            calls += 1
            return calls * 10

        src = core.AnonymousComputedSource(compute)
        seen = [await src.use(), await src.use(), calls]
        src.invalidate()
        seen.append(await src.use())
        assert seen == [10, 10, 1, 20]
        return seen
    await both(run)


async def test_anonymous_source_as_dependency():
    async def run(core, inputs, ser, hub):
        state = {"v": 1}

        async def _value():
            return state["v"]

        src = core.AnonymousComputedSource(lambda s: _value())
        src.computer = lambda s: _value()

        class S(core.ComputeService):
            @core.compute_method
            async def doubled(self) -> int:
                return 2 * await src.use()

        svc = S()
        seen = [await svc.doubled()]
        doubled = await core.get_existing(lambda: svc.doubled())
        state["v"] = 5
        src.invalidate()
        seen += [doubled.is_invalidated, await svc.doubled()]
        assert seen == [2, True, 10]
        return seen
    await both(run)


async def test_invalidation_delay_debounces():
    async def run(core, inputs, ser, hub):
        class S(core.ComputeService):
            @core.compute_method(invalidation_delay=0.05)
            async def get(self) -> int:
                return 1

        svc = S(hub)
        node = await core.capture(lambda: svc.get())
        seen = [node.invalidate(), node.is_consistent, node.invalidate()]
        await asyncio.wait_for(node.when_invalidated(), 2.0)
        seen.append(node.is_invalidated)
        node2 = await core.capture(lambda: svc.get())
        seen += [node2.invalidate(immediately=True), node2.is_invalidated]
        assert seen == [True, True, False, True, True, True]
        return seen
    await both(run)


async def test_hot_path_coherence_after_invalidate_and_collect():
    async def run(core, inputs, ser, hub):
        class Svc(core.ComputeService):
            def __init__(self, hub=None):
                super().__init__(hub)
                self.calls = 0
                self.val = 1

            @core.compute_method
            async def get(self, k: int) -> int:
                self.calls += 1
                return self.val

        svc = Svc(hub)
        seen = [await svc.get(5), await svc.get(5), svc.calls]
        svc.val = 2
        with core.invalidating():
            await svc.get(5)
        seen += [await svc.get(5), svc.calls, await svc.get(5), svc.calls,
                 await svc.get(k=5), svc.calls]
        node = await core.capture(lambda: svc.get(5))
        del node
        gc.collect()
        seen.append(await svc.get(5))
        assert seen == [1, 1, 1, 2, 2, 2, 2, 2, 2, 2]
        return seen
    await both(run)
