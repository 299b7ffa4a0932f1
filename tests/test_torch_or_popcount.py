"""Parity of the port's ``or_popcount`` (plain PyTorch path on the CPU)
with the JAX package's Pallas kernel, which runs in interpret mode off-TPU
as ``tests/test_pallas_kernels.py`` runs it. Tolerance: exact — the data are
integer words and bit counts. ``tests/test_torch_gpu.py`` holds the CUDA
kernel against the plain version on the card."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stl_fusion_tpu.ops.pallas_kernels import or_popcount as jax_or_popcount
from stl_fusion_tpu_torch.ops import or_popcount as port_mod
from stl_fusion_tpu_torch.ops.or_popcount import or_popcount


def _both(new, old):
    jm, jc = jax_or_popcount(jnp.asarray(new), jnp.asarray(old))
    pm, pc = or_popcount(torch.from_numpy(new), torch.from_numpy(old))
    return (np.asarray(jm), int(jc)), (pm.numpy(), pc)


@pytest.mark.parametrize("n", [7, 128, 32768, 40000])
def test_or_popcount_matches_jax(n):
    rng = np.random.default_rng(n)
    new = rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)
    old = rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)
    (jm, jc), (pm, pc) = _both(new, old)
    np.testing.assert_array_equal(pm, jm)
    assert pc.dtype == torch.int64 and pc.dim() == 0
    assert int(pc) == jc == int(np.bitwise_count((new & ~old).astype(np.uint32)).sum())


def test_or_popcount_zero_delta_matches_jax():
    x = np.full(1000, 0x0F0F0F0F, dtype=np.int32)
    (jm, jc), (pm, pc) = _both(x, x)
    assert int(pc) == jc == 0
    np.testing.assert_array_equal(pm, jm)


def test_or_popcount_bit31_matches_jax():
    """Words with only the sign bit set: ``1 << 31`` is negative in int32."""
    new = np.array([np.int32(-(2**31)), -1, 1, 0, np.int32(-(2**31))], dtype=np.int32)
    old = np.array([0, np.int32(-(2**31)), 0, -1, np.int32(-(2**31))], dtype=np.int32)
    (jm, jc), (pm, pc) = _both(new, old)
    np.testing.assert_array_equal(pm, jm)
    assert int(pc) == jc == 1 + 31 + 1


def test_or_popcount_in_place_merge():
    rng = np.random.default_rng(5)
    new = torch.from_numpy(rng.integers(-(2**31), 2**31, size=77, dtype=np.int32))
    old = torch.from_numpy(rng.integers(-(2**31), 2**31, size=77, dtype=np.int32))
    want_m, want_c = or_popcount(new, old)
    merged, count = or_popcount(new, old, out=old)
    assert merged.data_ptr() == old.data_ptr()
    assert torch.equal(old, want_m) and int(count) == int(want_c)


def test_or_popcount_cpu_takes_plain_path_without_launch():
    port_mod.launches = 0
    a = torch.arange(64, dtype=torch.int32)
    or_popcount(a, torch.zeros_like(a))
    assert port_mod.launches == 0


def test_or_popcount_rejects_bad_inputs():
    with pytest.raises(ValueError):
        or_popcount(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        or_popcount(torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32))


def _words(rng, n):
    """Random int32 words with bit 31 set in some of them (negative)."""
    return rng.integers(-(2**31), 2**31, size=n, dtype=np.int32)


def _jax(new, old):
    jm, jc = jax_or_popcount(jnp.asarray(new), jnp.asarray(old))
    return np.asarray(jm), int(jc)


@pytest.mark.parametrize("n", [7, 40001])
@pytest.mark.parametrize("alias", [False, True])
def test_or_popcount_gate_matches_jax(n, alias):
    """The gate form: the merge and count are JAX's, the delta is new & ~old
    (the fresh seeds); with ``alias`` the merge goes into ``old`` and the
    delta into ``new``, as the dense wave's seed gate calls it."""
    rng = np.random.default_rng(n + alias)
    new_np, old_np = _words(rng, n), _words(rng, n)
    jm, jc = _jax(new_np, old_np)
    new, old = torch.from_numpy(new_np.copy()), torch.from_numpy(old_np.copy())
    if alias:
        merged, delta, count = port_mod.or_popcount_gate(new, old, out=old, delta=new)
        assert merged.data_ptr() == old.data_ptr() and delta.data_ptr() == new.data_ptr()
    else:
        merged, delta, count = port_mod.or_popcount_gate(new, old)
        np.testing.assert_array_equal(new.numpy(), new_np)
        np.testing.assert_array_equal(old.numpy(), old_np)
    np.testing.assert_array_equal(merged.numpy(), jm)
    np.testing.assert_array_equal(delta.numpy(), new_np & ~old_np)
    assert count.dtype == torch.int64 and count.dim() == 0 and int(count) == jc


@pytest.mark.parametrize("n", [5, 128, 40001])
@pytest.mark.parametrize("alias", [False, True])
def test_or_popcount_delta_matches_jax(n, alias):
    """The delta form (the union finalize): new & ~old and JAX's count, with
    no merge: ``old`` never changes, ``new`` only when it is the delta."""
    rng = np.random.default_rng(100 + n + alias)
    new_np, old_np = _words(rng, n), _words(rng, n)
    _, jc = _jax(new_np, old_np)
    new, old = torch.from_numpy(new_np.copy()), torch.from_numpy(old_np.copy())
    delta, count = port_mod.or_popcount_delta(new, old, delta=new if alias else None)
    np.testing.assert_array_equal(delta.numpy(), new_np & ~old_np)
    np.testing.assert_array_equal(old.numpy(), old_np)
    assert (delta.data_ptr() == new.data_ptr()) == alias
    assert count.dtype == torch.int64 and count.dim() == 0 and int(count) == jc


def test_or_popcount_forms_bit31_match_jax():
    """Only the sign bit set: every form counts it once."""
    new_np = np.array([np.int32(-(2**31)), -1, 1, 0, np.int32(-(2**31))], dtype=np.int32)
    old_np = np.array([0, np.int32(-(2**31)), 0, -1, np.int32(-(2**31))], dtype=np.int32)
    jm, jc = _jax(new_np, old_np)
    new, old = torch.from_numpy(new_np), torch.from_numpy(old_np)
    merged, delta, count = port_mod.or_popcount_gate(new, old)
    np.testing.assert_array_equal(merged.numpy(), jm)
    np.testing.assert_array_equal(delta.numpy(), new_np & ~old_np)
    assert int(count) == jc == 33
    delta, count = port_mod.or_popcount_delta(new, old)
    np.testing.assert_array_equal(delta.numpy(), new_np & ~old_np)
    assert int(count) == jc


@pytest.mark.parametrize("n_shards, words", [(1, 3), (8, 5), (3, 41)])
def test_or_popcount_shards_matches_jax_per_shard(n_shards, words):
    """The shards form against one JAX call per shard: each shard's invalid
    words take the merge of its frontier row's first ``words`` words (the
    row's padding past them holds garbage and is never read), its count is
    JAX's, and the total is their sum."""
    from stl_fusion_tpu_torch.ops.wave import ShardTable

    rng = np.random.default_rng(words * 10 + n_shards)
    inv_np = [_words(rng, words) for _ in range(n_shards)]
    invalid = [torch.from_numpy(x.copy()) for x in inv_np]
    edges = [torch.zeros(4, dtype=torch.int32) for _ in range(n_shards)]
    epochs = [torch.zeros(32 * words - 31, dtype=torch.int32) for _ in range(n_shards)]
    table = ShardTable(edges, edges, edges, epochs, invalid)
    frontier_np = _words(rng, (n_shards, table.width))
    counts, total = port_mod.or_popcount_shards(torch.from_numpy(frontier_np.copy()), table)
    assert counts.dtype == total.dtype == torch.int64
    assert counts.shape == (n_shards,) and total.dim() == 0
    for d in range(n_shards):
        jm, jc = _jax(frontier_np[d, :words], inv_np[d])
        np.testing.assert_array_equal(invalid[d].numpy(), jm)
        assert int(counts[d]) == jc
    assert int(total) == int(counts.sum())


def test_or_popcount_forms_cpu_take_plain_path_without_launch():
    port_mod.launches = 0
    port_mod.form_launches.update(dict.fromkeys(port_mod.form_launches, 0))
    a = torch.arange(64, dtype=torch.int32)
    port_mod.or_popcount_gate(a, torch.zeros_like(a))
    port_mod.or_popcount_delta(a, torch.zeros_like(a))
    assert port_mod.launches == 0 and not any(port_mod.form_launches.values())


def test_or_popcount_forms_reject_bad_inputs():
    x, y = torch.zeros(4, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        port_mod.or_popcount_gate(x, x, delta=y)
    with pytest.raises(ValueError):
        port_mod.or_popcount_delta(x.long(), x.long())
    with pytest.raises(ValueError):
        port_mod.or_popcount_delta(x, x[None])
