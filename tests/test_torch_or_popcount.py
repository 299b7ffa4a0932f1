"""Parity of the port's ``or_popcount`` (plain PyTorch path on the CPU)
with the JAX package's Pallas kernel, which runs in interpret mode off-TPU
as ``tests/test_pallas_kernels.py`` runs it. Tolerance: exact — the data are
integer words and bit counts. ``tests/test_torch_gpu.py`` holds the CUDA
kernel against the plain version on the card."""
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
