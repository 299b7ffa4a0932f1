"""Parity of the read-throughput twin (``stl_fusion_tpu_torch/
read_throughput.py``, the twin of ``perf/read_throughput.py``) with the
JAX package, and the pin of the fused-dispatch fault repair.

The twin runs every mode of the script at a small size through both
packages (``run_read(api=ReadApi(<jax modules>))``; the JAX side draws its
device ids with ``jax.random`` and runs its chain as the script's
``lax.scan``). Without the mutator, each mode's totals, DB reads, remote
round trips, the local vectorized modes' final table rows (``read_batch``
of every host id) and the chain's readback must be EQUAL. With the
mutator, each package passes the twin's own exactness checks (every
reader's rows, every user equal to the DAL once the mutator stops, the
chain equal to plain torch) and the totals must be equal.

The repair: torch reports a failed CUDA launch as a ``RuntimeError``. A
``RuntimeError`` subclass raised by the sweep kernel's entry
(``ops/topo_wave.py::topo_sweep``) inside a fused super-round or pipeline
chain is a FAULT (``faults``, ``chain_faults``, the watchdog degraded and
recovered), never the counted "not fusible" fallback (``NotFusible``),
and the contained re-run leaves the sequential twin's state. Tolerance:
exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stl_fusion_tpu.client as jclient
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.rpc as jrpc
from stl_fusion_tpu_torch.read_throughput import MODES, ReadApi, port_api, run_read

SIZES = {"fusion_scalar": 300, "fusion_scalar_hot": 300, "fusion_rpc_client": 150,
         "fusion_rpc_vectorized": (3, 512), "fusion_rpc_vectorized_hits": (3, 512),
         "no_fusion": 200, "fusion_vectorized": (3, 512),
         "fusion_vectorized_device_ids": (3, 512), "fusion_device_chained": (4, 1024)}


def jax_chain(table, n_chained, batch):
    """The script's ``run_device_chained`` with its readback and the plain
    sum (every partial sum here is an integer below 2**24, so float32 is
    exact)."""
    rng = np.random.default_rng(7)
    id_np = rng.integers(0, table.n_rows, size=(n_chained, batch)).astype(np.int32)

    @jax.jit
    def run_all(values, ids):
        acc, _ = jax.lax.scan(lambda acc, i: (acc + values[i].sum(), None), jnp.float32(0), ids)
        return acc

    float(run_all(table.values, jnp.asarray(id_np)))
    t0 = time.perf_counter()
    got = float(run_all(table.values, jnp.asarray(id_np)))
    dt = time.perf_counter() - t0
    plain = float(np.asarray(table.values)[id_np].astype(np.float64).sum())
    return n_chained * batch, dt, got, plain


def jax_device_ids(seed, iterations, batch):
    keys = jax.random.split(jax.random.PRNGKey(seed), iterations)
    for i in range(iterations):
        yield jax.random.randint(keys[i], (batch,), 0, 1000, dtype=jnp.int32)


JAX_API = ReadApi(jcore, jclient, jrpc, {}, jax_device_ids, jax_chain, np.asarray,
                  lambda: None, "stl_fusion_tpu")


def observed(record):
    out = {}
    for mode, m in record["modes"].items():
        out[mode] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in m.items() if k != "seconds"}
    return out


def test_read_twin_matches_jax_without_the_mutator():
    want = run_read(sizes=SIZES, api=JAX_API, mutate=False)
    got = run_read(sizes=SIZES, device="cpu", mutate=False)
    assert list(got["modes"]) == list(MODES)
    assert observed(got) == observed(want)
    assert got["modes"]["fusion_vectorized"]["db_reads"] == 1000


def test_read_twin_checks_hold_under_the_mutator():
    want = run_read(sizes=SIZES, api=JAX_API)
    got = run_read(sizes=SIZES, device="cpu")
    assert {m: got["modes"][m]["ops"] for m in MODES} == \
        {m: want["modes"][m]["ops"] for m in MODES}
    assert got["speedup_vectorized_vs_none"] > 0


def test_read_twin_default_is_the_card():
    from stl_fusion_tpu_torch.read_throughput import SIZES as FULL, quick_sizes

    assert FULL["fusion_vectorized_device_ids"] == (64, 1_048_576)
    assert quick_sizes()["fusion_scalar"] == FULL["fusion_scalar"] // 10
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_api()


# ---------------------------------------------------------------- the repair
class LaunchFailed(RuntimeError):
    """What torch raises for a failed CUDA launch (``torch.AcceleratorError``
    is a ``RuntimeError``), standing in on the CPU."""


def fail_once(monkeypatch):
    """The sweep kernel's entry fails its next launch, then launches."""
    import stl_fusion_tpu_torch.ops.topo_wave as ptw

    real, armed = ptw.topo_sweep, [True]

    def sweep(*args, **kwargs):
        if armed and armed.pop():
            raise LaunchFailed("CUDA error: an illegal memory access was encountered")
        return real(*args, **kwargs)

    monkeypatch.setattr(ptw, "topo_sweep", sweep)


def test_superround_kernel_fault_is_a_fault_not_an_eager_round(monkeypatch):
    import test_torch_superround as tsr
    from stl_fusion_tpu_torch.resilience import WaveWatchdog

    bursts = tsr.round_bursts(3, rng=np.random.default_rng(9))
    hub, b, _svc, table, blk = tsr.make_stack(tsr.PORT)
    old = tsr.pcore.set_default_hub(hub)
    try:
        wd = b.attach_watchdog(WaveWatchdog(recovery_bursts=1))
        prog = b.enable_super_rounds(blk, depth=3)
        fail_once(monkeypatch)
        ticket = prog.dispatch(prog.stage(bursts))
        assert ticket.done and ticket.fallback
        assert prog.faults == 1 and wd.faults == 1 and wd.mode == wd.MODE_FUSED
        _c, _f, seq_state = tsr.sequential(tsr.PORT, bursts)
        np.testing.assert_array_equal(np.asarray(b.graph.invalid_mask()), seq_state["invalid"])
        np.testing.assert_array_equal(tsr.values(table), seq_state["values"])
    finally:
        tsr.pcore.set_default_hub(old)


def test_pipeline_kernel_fault_is_a_chain_fault_not_an_eager_wave(monkeypatch):
    import test_torch_nonblocking as tnb
    from stl_fusion_tpu_torch.resilience import WaveWatchdog

    seeds = tnb.wave_seeds(4, rng=np.random.default_rng(5))
    _h, b1, _s, _t, blk1 = tnb.make_stack(tnb.PORT)
    want = [b1.cascade_rows_batch(blk1, w) for w in seeds]
    hub, b2, _s2, _t2, blk2 = tnb.make_stack(tnb.PORT)
    wd = b2.attach_watchdog(WaveWatchdog(recovery_bursts=1))
    pipe = hub.enable_nonblocking(fuse_depth=4)
    fail_once(monkeypatch)
    tickets = [pipe.submit_rows(blk2, w) for w in seeds]
    pipe.drain()
    st = pipe.stats()
    assert st["chain_faults"] == 1 and st["eager_waves"] == 0
    assert wd.faults == 1 and wd.fallbacks == 1
    assert [t.count for t in tickets] == want
    np.testing.assert_array_equal(b1.graph._h_invalid, b2.graph._h_invalid)
