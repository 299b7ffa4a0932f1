"""Parity of the port's L0 substrate (``stl_fusion_tpu_torch/utils``) with the
JAX package's: the 15 cases of ``tests/test_utils.py`` (results, LTags,
async events, lock sets, timers, channels, collections, the wire format)
and the 22 of ``tests/test_utils_extra.py`` (symbols, requirements, the
computing and file-system caches, the stochastic counter, the review
fixes, and the host library rebuilt from source), each run as one scenario
through both packages with the reference's assertions, their observations
required EQUAL. The names come from each package's ``utils`` itself, so the
twins also hold the package exports. The host library case builds the
port's ``csrc/graphpack.cpp`` through ``ops/_build.py::load_host`` from a
copy in an empty directory (the JAX twin rebuilds ``stl_fusion_tpu.native``
the same way) and requires the same ELL tables. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
import dataclasses
import random

import numpy as np
import pytest

import stl_fusion_tpu.utils as jutils
import stl_fusion_tpu_torch.utils as putils

PKGS = {"jax": jutils, "port": putils}


def both(scenario, *args):
    got = [scenario(u, *args) for u in PKGS.values()]
    assert got[0] == got[1], got
    return got[1]


async def both_async(scenario, *args):
    got = [await scenario(u, *args) for u in PKGS.values()]
    assert got[0] == got[1], got
    return got[1]


# ---------------------------------------------------------------- Result

def test_result_value_and_error():
    def run(u):
        r = u.Result.ok(42)
        assert r.has_value and not r.has_error and r.value == 42
        e = u.Result.err(ValueError("boom"))
        assert e.has_error
        with pytest.raises(ValueError):
            _ = e.value
        seen = [e.value_or_default, u.Result.ok(1) == u.Result.ok(1),
                u.Result.err(ValueError("x")) == u.Result.err(ValueError("x")),
                u.Result.ok(1) != u.Result.err(ValueError("x"))]
        assert seen == [None, True, True, True]
        return seen
    both(run)


def test_result_capture_and_map():
    def run(u):
        r = u.Result.capture(lambda: 1 / 0)
        assert r.has_error and isinstance(r.error, ZeroDivisionError)
        seen = [u.Result.ok(2).map(lambda x: x * 3).value, r.map(lambda x: x).has_error]
        assert seen == [6, True]
        return seen
    both(run)


# ---------------------------------------------------------------- LTag

def test_ltag_format_parse_roundtrip():
    def run(u):
        seen = []
        for n in (0, 1, 61, 62, 12345678901234):
            t = u.LTag(n)
            assert u.LTag.parse(t.format()) == t
            seen.append(t.format())
        assert u.LTag(0).is_none and str(u.LTag(10)) == "@A"
        return seen
    both(run)


def test_ltag_generator_never_repeats_current():
    def run(u):
        gen = u.LTagVersionGenerator(seed=1)
        cur = gen.next()
        seen = [int(cur)]
        for _ in range(100):
            nxt = gen.next(cur)
            assert nxt != cur and nxt != 0
            cur = nxt
            seen.append(int(cur))
        return seen
    both(run)


# ---------------------------------------------------------------- AsyncEvent

async def test_async_event_chain():
    async def run(u):
        ev = u.AsyncEvent("a")
        assert ev.is_latest

        async def producer():
            await asyncio.sleep(0.01)
            ev.create_next("b").create_next("c")

        task = asyncio.ensure_future(producer())
        nxt = await ev.when_next()
        seen = [nxt.value, (await nxt.when_next()).value, ev.latest().value]
        await task
        hit = await ev.when(lambda v: v == "c")
        seen.append(hit.value)
        assert seen == ["b", "c", "c", "c"]
        return seen
    await both_async(run)


# ---------------------------------------------------------------- AsyncLockSet

async def test_async_lock_set_serializes_per_key():
    async def run(u):
        locks = u.AsyncLockSet()
        order = []

        async def work(key, tag, hold):
            async with locks.lock(key):
                order.append((key, tag, "in"))
                await asyncio.sleep(hold)
                order.append((key, tag, "out"))

        await asyncio.gather(work("k", 1, 0.02), work("k", 2, 0.0), work("other", 3, 0.0))
        k_events = [(t, io) for key, t, io in order if key == "k"]
        assert k_events == [(1, "in"), (1, "out"), (2, "in"), (2, "out")]
        assert len(locks) == 0
        return k_events
    await both_async(run)


async def test_async_lock_set_reentry_fails():
    async def run(u):
        locks = u.AsyncLockSet()
        async with locks.lock("k"):
            with pytest.raises(u.LockReentryError):
                async with locks.lock("k"):
                    pass
        async with locks.lock("a"):
            async with locks.lock("b"):
                pass
        return len(locks)
    await both_async(run)


# ---------------------------------------------------------------- timers

async def test_timer_set_fires_and_updates():
    async def run(u):
        clock = u.TestClock()
        fired = []
        timers = u.ConcurrentTimerSet(fired.append, quanta=0.001, clock=clock)
        timers.add_or_update("x", clock.now() + 100.0)
        timers.add_or_update("y", clock.now() + 0.5)
        timers.add_or_update("x", clock.now() + 0.5)
        clock.advance(1.0)
        timers.fire_all_due()
        seen = [sorted(fired)]
        fired.clear()
        timers.add_or_update("z", clock.now() + 0.5)
        seen.append(timers.remove("z"))
        clock.advance(1.0)
        timers.fire_all_due()
        seen.append(list(fired))
        await timers.stop()
        assert seen == [["x", "y"], True, []]
        return seen
    await both_async(run)


async def test_timer_set_background_task():
    async def run(u):
        import time

        fired = asyncio.Event()
        timers = u.ConcurrentTimerSet(lambda item: fired.set(), quanta=0.005)
        timers.add_or_update("a", time.monotonic() + 0.02)
        await asyncio.wait_for(fired.wait(), timeout=2.0)
        await timers.stop()
        return fired.is_set()
    await both_async(run)


# ---------------------------------------------------------------- channels

async def test_twisted_channel_pair():
    async def run(u):
        a, b = u.create_twisted_pair()
        await a.writer.send("ping")
        seen = [await b.reader.receive()]
        await b.writer.send("pong")
        seen.append(await a.reader.receive())
        a.close()
        with pytest.raises(u.ChannelClosedError):
            await b.reader.receive()
        assert seen == ["ping", "pong"]
        return seen
    await both_async(run)


async def test_channel_close_wakes_receiver():
    async def run(u):
        ch = u.Channel()
        woke = []

        async def receiver():
            with pytest.raises(u.ChannelClosedError):
                await ch.receive()
            woke.append(True)

        task = asyncio.ensure_future(receiver())
        await asyncio.sleep(0.01)
        ch.close()
        await asyncio.wait_for(task, 1.0)
        return woke
    await both_async(run)


# ---------------------------------------------------------------- misc

def test_recently_seen_map():
    def run(u):
        m = u.RecentlySeenMap(capacity=3, max_age=100.0)
        seen = [m.try_add("a"), m.try_add("a"), m.try_add("b"), m.try_add("c"), m.try_add("d"),
                "a" in m, len(m)]
        assert seen == [True, False, True, True, True, False, 3]
        return seen
    both(run)


def test_option_set():
    def run(u):
        opts = u.OptionSet()
        opts.set(42, key="answer")
        opts.set("hello")
        seen = [opts.get(str), "answer" in opts]
        opts.remove(str)
        seen.append(opts.get(str))
        assert seen == ["hello", True, None]
        return seen
    both(run)


# ---------------------------------------------------------------- wire

def _point_type(u):
    """One ``_TwinPoint`` wire type per package (each package keeps its own
    registry)."""
    cls = getattr(u, "_twin_point", None)
    if cls is None:
        @u.wire_type("_TwinPoint")
        @dataclasses.dataclass(frozen=True)
        class _TwinPoint:
            x: int
            y: int

        cls = _TwinPoint
        u._twin_point = cls
    return cls


def test_wire_roundtrip():
    def run(u):
        point = _point_type(u)
        payload = {"k": [1, 2.5, "s", None, True], "p": point(1, 2), "b": b"\x00\x01"}
        wire = u.dumps(payload)
        out = u.loads(wire)
        assert out["k"] == [1, 2.5, "s", None, True]
        assert out["p"] == point(1, 2) and out["b"] == b"\x00\x01"
        assert u.loads(u.dumps(u.LTag(123))) == u.LTag(123)
        return wire, (out["p"].x, out["p"].y)
    both(run)


def test_exception_info_roundtrip():
    def run(u):
        info = u.ExceptionInfo.capture(ValueError("bad"))
        exc = info.to_exception()
        assert isinstance(exc, ValueError) and str(exc) == "bad"

        class Custom(Exception):
            pass

        remote = u.ExceptionInfo.capture(Custom("z")).to_exception()
        assert isinstance(remote, u.RemoteError) and remote.type_name == "Custom"
        return type(exc).__name__, str(exc), remote.type_name
    both(run)


# ---------------------------------------------------------------- test_utils_extra twins

class TestSymbol:
    def test_identity_and_equality(self):
        def run(u):
            a = u.Symbol("users.Get")
            b = u.Symbol("users." + "Get")
            assert a == b and a is not None
            assert str(a) == "users.Get" and a.value == "users.Get"
            return str(a), a == b
        both(run)

    def test_empty(self):
        def run(u):
            seen = [u.Symbol("").is_empty, u.Symbol("") == u.Symbol.EMPTY,
                    u.Symbol("x").is_empty]
            assert seen == [True, True, False]
            return seen
        both(run)

    def test_idempotent_wrap(self):
        def run(u):
            a = u.Symbol("k")
            assert u.Symbol(a) is a
            return True
        both(run)

    def test_usable_as_dict_key_with_str(self):
        def run(u):
            d = {u.Symbol("a"): 1}
            assert d["a"] == 1 and u.Symbol("a") in d
            return d["a"]
        both(run)


class TestRequirement:
    def test_must_exist(self):
        def run(u):
            seen = [u.MUST_EXIST.check("x"), u.MUST_EXIST.check(0)]
            with pytest.raises(u.RequirementError):
                u.MUST_EXIST.check(None)
            with pytest.raises(u.RequirementError):
                u.MUST_EXIST.check("")
            assert seen == ["x", 0]
            return seen
        both(run)

    def test_must_exist_helper_names_value(self):
        def run(u):
            with pytest.raises(u.RequirementError, match="user") as e:
                u.must_exist(None, "user")
            assert u.must_exist(5, "n") == 5
            return str(e.value)
        both(run)

    def test_func_requirement_and_combination(self):
        def run(u):
            positive = u.Requirement(lambda v: v > 0, description="positive")
            even = u.Requirement(lambda v: v % 2 == 0, description="even")
            req = positive & even
            seen = [req.check(4)]
            for bad in (3, -2):
                with pytest.raises(Exception) as e:
                    req.check(bad)
                seen.append(type(e.value).__name__)
            return seen
        both(run)

    def test_custom_error(self):
        def run(u):
            class MissingUser(Exception):
                pass

            req = u.MUST_EXIST.with_error(lambda v: MissingUser())
            with pytest.raises(MissingUser):
                req.check(None)
            return True
        both(run)


async def _ret(k):
    return k


class TestComputingCache:
    def test_single_flight(self):
        async def go(u):
            calls = []

            async def compute(key):
                calls.append(key)
                await asyncio.sleep(0.01)
                return key * 2

            cache = u.ComputingCache(compute)
            results = await asyncio.gather(*(cache.get(7) for _ in range(10)))
            assert results == [14] * 10 and calls == [7] and cache.try_get(7) == 14
            return results, calls

        both(lambda u: asyncio.run(go(u)))

    def test_errors_not_cached(self):
        async def go(u):
            attempts = []

            async def compute(key):
                attempts.append(key)
                if len(attempts) == 1:
                    raise RuntimeError("transient")
                return key

            cache = u.FastComputingCache(compute)
            with pytest.raises(RuntimeError):
                await cache.get(1)
            value = await cache.get(1)
            assert value == 1 and len(attempts) == 2
            return value, attempts

        both(lambda u: asyncio.run(go(u)))

    def test_invalidate(self):
        async def go(u):
            count = [0]

            async def compute(key):
                count[0] += 1
                return count[0]

            cache = u.ComputingCache(compute)
            seen = [await cache.get("k"), await cache.get("k")]
            cache.invalidate("k")
            seen.append(await cache.get("k"))
            assert seen == [1, 1, 2]
            return seen

        both(lambda u: asyncio.run(go(u)))

    def test_capacity_eviction(self):
        async def go(u):
            cache = u.ComputingCache(lambda k: _ret(k), capacity=2)
            for i in range(4):
                await cache.get(i)
            assert len(cache) <= 2
            return len(cache)

        both(lambda u: asyncio.run(go(u)))


class TestFileSystemCache:
    def test_roundtrip(self, tmp_path):
        def run(u, root):
            cache = u.FileSystemCache(str(root / u.__name__))
            seen = [cache.try_get("a")]
            cache.set("a", b"hello")
            seen.append(cache.try_get("a"))
            cache.set("a", b"world")
            seen.append(cache.try_get("a"))
            cache.remove("a")
            seen.append(cache.try_get("a"))
            assert seen == [None, b"hello", b"world", None]
            return seen
        both(run, tmp_path)

    def test_clear_and_tuple_keys(self, tmp_path):
        def run(u, root):
            cache = u.FileSystemCache(str(root / u.__name__))
            cache.set(("svc", "method", 1), b"x")
            seen = [cache.try_get(("svc", "method", 1))]
            cache.clear()
            seen.append(cache.try_get(("svc", "method", 1)))
            assert seen == [b"x", None]
            return seen
        both(run, tmp_path)


class TestStochasticCounter:
    def test_sampled_increments_approximate_total(self):
        def run(u):
            c = u.StochasticCounter(sample_period_log2=3, rng=random.Random(42))
            n = 10_000
            for _ in range(n):
                c.increment()
            assert abs(c.approximate_value - n) / n < 0.2
            return c.approximate_value
        both(run)

    def test_period_zero_counts_exactly(self):
        def run(u):
            c = u.StochasticCounter(sample_period_log2=0)
            for _ in range(100):
                assert c.increment() is not None
            assert c.approximate_value == 100
            return c.approximate_value
        both(run)

    def test_decrement_floors_at_zero(self):
        def run(u):
            c = u.StochasticCounter(sample_period_log2=0)
            c.decrement()
            assert c.approximate_value == 0
            return c.approximate_value
        both(run)


class TestReviewFixes:
    def test_must_exist_rejects_empty_collections(self):
        def run(u):
            for empty in ([], {}, set(), ()):
                with pytest.raises(u.RequirementError):
                    u.MUST_EXIST.check(empty)
            seen = [u.MUST_EXIST.check([1]), u.MUST_EXIST.check(0.0)]
            assert seen == [[1], 0.0]
            return seen
        both(run)

    def test_symbol_interning_identity_and_collectability(self):
        def run(u):
            import gc

            a = u.Symbol("dyn-key-1")
            assert u.Symbol("dyn-key-1") is a
            key_count = len(u.Symbol._interned)
            del a
            gc.collect()
            assert len(u.Symbol._interned) <= key_count
            return "dyn-key-1" in {str(k) for k in u.Symbol._interned}
        both(run)

    def test_computing_cache_leader_cancel_does_not_poison_waiters(self):
        async def go(u):
            started = asyncio.Event()

            async def compute(key):
                started.set()
                await asyncio.sleep(0.05)
                return key * 10

            cache = u.ComputingCache(compute)
            leader = asyncio.ensure_future(cache.get(4))
            await started.wait()
            waiter = asyncio.ensure_future(cache.get(4))
            await asyncio.sleep(0)
            leader.cancel()
            value = await waiter
            assert value == 40
            return value

        both(lambda u: asyncio.run(go(u)))

    def test_fs_cache_concurrent_writers_same_key(self, tmp_path):
        def run(u, root):
            import threading

            cache = u.FileSystemCache(str(root / u.__name__))
            payloads = [bytes([i]) * 4096 for i in range(8)]

            def write(p):
                for _ in range(20):
                    cache.set("k", p)

            threads = [threading.Thread(target=write, args=(p,)) for p in payloads]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            final = cache.try_get("k")
            assert final in payloads
            return len(final)
        both(run, tmp_path)


def test_native_rebuilds_from_source(tmp_path, monkeypatch):
    """No committed binaries: each package's host graph packer rebuilds from
    a copy of its source in an empty directory (the JAX package's
    ``native.load_graphpack``; the port's ``ops/_build.py::load_host``,
    content-hashed into its build directory), and both give the same ELL
    table."""
    import shutil

    import stl_fusion_tpu.native as native
    import stl_fusion_tpu_torch.ops._build as pbuild
    import stl_fusion_tpu_torch.ops.ell_wave as pell

    src = np.array([0, 0, 1], dtype=np.int32)
    dst = np.array([1, 2, 3], dtype=np.int32)

    jdir = tmp_path / "jax"
    jdir.mkdir()
    shutil.copy(native._SRC, jdir / "graphpack.cpp")
    monkeypatch.setattr(native, "_DIR", str(jdir))
    monkeypatch.setattr(native, "_SRC", str(jdir / "graphpack.cpp"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    assert native.load_graphpack() is not None, "rebuild from source failed"
    assert list(jdir.glob("_graphpack_*.so"))
    want = native.native_build_ell(src, dst, 4, 4)

    pdir = tmp_path / "port"
    pdir.mkdir()
    shutil.copy(pbuild.CSRC / "graphpack.cpp", pdir / "graphpack.cpp")
    monkeypatch.setattr(pbuild, "CSRC", pdir)
    monkeypatch.setattr(pbuild, "BUILD_DIR", pdir / "_build")
    monkeypatch.setattr(pbuild, "_libs", {})
    got = pell._native_build_ell(src, dst, 4, 4)
    assert list((pdir / "_build").glob("graphpack_host_*.so")), "no content-hashed artifact built"

    assert want is not None and got[1] == want[1] >= 4 and got[0].shape[1] == 4
    np.testing.assert_array_equal(got[0], want[0])
