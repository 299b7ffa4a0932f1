"""Parity of the port's state containers (``stl_fusion_tpu_torch/state``)
with the JAX package's: the 7 cases of ``tests/test_state.py``
(MutableState, ComputedState update cycles, retries, change streams,
``when`` and an invalidation storm), each run as one scenario through both
packages with the same assertions, their observable sequences (values seen,
update counts, change streams) required EQUAL."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio

import pytest

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.state as jstate
import stl_fusion_tpu.utils as jutils
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.state as pstate
import stl_fusion_tpu_torch.utils as putils

PKGS = {"jax": (jcore, jstate, jutils), "port": (pcore, pstate, putils)}


async def both(scenario):
    """Run ``scenario(core, state, utils, hub)`` on each package under a
    fresh default hub; the observations must be equal."""
    got = []
    for core, state, utils in PKGS.values():
        hub = core.FusionHub()
        old = core.set_default_hub(hub)
        try:
            got.append(await scenario(core, state, utils, hub))
        finally:
            core.set_default_hub(old)
    assert got[0] == got[1], got
    return got[1]


async def test_mutable_state_set_is_synchronous():
    async def run(core, state, utils, hub):
        s = state.MutableState(1)
        seen = [s.value]
        s.set(2)
        seen.append(s.value)
        s.set_error(ValueError("bad"))
        assert isinstance(s.error, ValueError)
        seen.append(s.last_non_error_value)
        s.set(3)
        seen += [s.value, s.snapshot.update_count]
        assert seen == [1, 2, 2, 3, 3]
        return seen
    await both(run)


async def test_mutable_state_invalidates_dependents():
    async def run(core, state, utils, hub):
        price = state.MutableState(10)
        qty = state.MutableState(3)

        class Cart(core.ComputeService):
            calls = 0

            @core.compute_method
            async def total(self) -> int:
                Cart.calls += 1
                return await price.use() * await qty.use()

        svc = Cart()
        seen = [await svc.total(), await svc.total(), Cart.calls]
        price.set(20)
        seen.append(await svc.total())
        qty.set(5)
        seen += [await svc.total(), Cart.calls]
        assert seen == [30, 30, 1, 60, 100, 3]
        return seen
    await both(run)


async def test_computed_state_update_cycle():
    async def run(core, state, utils, hub):
        source = state.MutableState(1)
        seen = []

        async def compute():
            v = await source.use()
            seen.append(v)
            return v * 100

        st = state.StateFactory().new_computed(
            compute, update_delayer=state.FixedDelayer.ZERO_UNSAFE)
        values = []
        try:
            await st.when_first_value()
            values.append(st.value)
            for v in (2, 3):
                source.set(v)
                await asyncio.sleep(0.05)
                values.append(st.value)
        finally:
            await st.dispose()
        assert values == [100, 200, 300] and seen == [1, 2, 3]
        return values, seen
    await both(run)


async def test_computed_state_retry_on_error():
    async def run(core, state, utils, hub):
        attempts = 0

        async def compute():
            nonlocal attempts
            attempts += 1
            if attempts < 3:
                raise RuntimeError("flaky")
            return "ok"

        st = state.ComputedState(
            compute,
            options=core.ComputedOptions.new(transient_error_invalidation_delay=0.01),
            update_delayer=state.UpdateDelayer(
                retry_delays=utils.RetryDelaySeq(min_delay=0.01, max_delay=0.02)),
        )
        st.start()
        try:
            for _ in range(300):
                await asyncio.sleep(0.01)
                if st._snapshot is not None and st.snapshot.last_non_error_computed is not None:
                    break
            assert st.last_non_error_value == "ok"
            assert attempts >= 3
            assert st.snapshot.error_count >= 2
        finally:
            await st.dispose()
        return st.last_non_error_value, min(attempts, 3)
    await both(run)


async def test_state_changes_stream():
    async def run(core, state, utils, hub):
        s = state.MutableState(0)
        got = []

        async def watcher():
            async for c in s.changes():
                got.append(c.output.value)
                if c.output.value >= 2:
                    return

        task = asyncio.ensure_future(watcher())
        await asyncio.sleep(0.02)
        s.set(1)
        await asyncio.sleep(0.02)
        s.set(2)
        await asyncio.wait_for(task, 2.0)
        assert got == [0, 1, 2]
        return got
    await both(run)


async def test_when_predicate():
    async def run(core, state, utils, hub):
        s = state.MutableState(0)

        async def bump():
            for i in range(1, 5):
                await asyncio.sleep(0.01)
                s.set(i)

        task = asyncio.ensure_future(bump())
        c = await s.when(lambda v: v >= 3)
        assert c.output.value >= 3
        await task
        return c.output.value >= 3, s.value
    await both(run)


@pytest.mark.parametrize("delay", [0.0, 0.005])
async def test_computed_state_invalidation_storm_converges(delay):
    """An invalidation storm racing the update loop ends CONVERGED to the
    final source value on both packages."""
    async def run(core, state, utils, hub):
        source = state.MutableState(0, hub)

        async def compute():
            return await source.use() * 2

        delayer = state.FixedDelayer.ZERO_UNSAFE if delay == 0.0 else state.FixedDelayer(delay)
        st = state.ComputedState(compute, hub, update_delayer=delayer)
        st.start()
        try:
            await st.when_first_value()
            for i in range(1, 301):
                source.set(i)
                if i % 7 == 0:
                    await asyncio.sleep(0)
            loop = asyncio.get_event_loop()
            deadline = loop.time() + 10.0
            while True:
                snap = st.snapshot
                if snap.computed.is_consistent and st.value == 600:
                    break
                assert loop.time() < deadline, f"state stuck at {st.value_or_default}"
                await asyncio.sleep(0.01)
        finally:
            await st.dispose()
        return st.value
    await both(run)
