"""Parity of the port's ring all-gather (``stl_fusion_tpu_torch.ops.ring_all_gather``)
with the JAX package's Pallas ``make_ring_all_gather``, run in interpret mode
under ``shard_map`` on the conftest's 8-device virtual CPU mesh. The port's
mesh is 8 CPU shards fed the same numpy words. Tolerance: exact (the words
are compared as uint32). ``tests/test_torch_gpu.py`` holds the CUDA kernel
against its plain version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stl_fusion_tpu.ops.pallas_kernels import make_ring_all_gather, ring_all_gather_supported
from stl_fusion_tpu.parallel.mesh import shard_map_compat
from stl_fusion_tpu_torch.ops import ring_all_gather as rag

N_DEV = 8


def _words(n_dev, chunk, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=n_dev * chunk, dtype=np.uint32)


@pytest.mark.parametrize("chunk", [128, 256])
def test_ring_plain_matches_jax_ring(chunk):
    if not ring_all_gather_supported():
        pytest.skip("jax on this image lacks the ring kernel's APIs")
    devices = jax.devices()
    assert len(devices) == N_DEV
    words = _words(N_DEV, chunk, chunk)
    mesh = Mesh(np.array(devices), ("graph",))
    ring = make_ring_all_gather("graph")

    @shard_map_compat(mesh=mesh, in_specs=P("graph"), out_specs=P("graph"))
    def gather_ring(w_local):
        return ring(w_local).reshape(N_DEV, -1)

    sharded = jax.device_put(jnp.asarray(words), NamedSharding(mesh, P("graph")))
    want = np.asarray(gather_ring(sharded)).reshape(N_DEV, N_DEV * chunk)

    chunks = [torch.from_numpy(words[d * chunk:(d + 1) * chunk].view(np.int32).copy())
              for d in range(N_DEV)]
    before = rag.launches
    got = rag.ring_all_gather(chunks)  # CPU tensors: the plain version
    assert rag.launches == before  # no kernel launched on the CPU
    assert len(got) == N_DEV
    for d in range(N_DEV):
        np.testing.assert_array_equal(got[d].numpy().view(np.uint32), want[d], err_msg=f"shard {d}")


@pytest.mark.parametrize("n_dev,chunk", [(1, 1), (2, 31), (3, 1), (3, 31), (8, 31)])
def test_ring_plain_equals_concatenation(n_dev, chunk):
    """Any shard count and any whole number of words: every shard ends with
    every chunk in shard order."""
    words = _words(n_dev, chunk, 100 * n_dev + chunk).view(np.int32)
    chunks = [torch.from_numpy(words[d * chunk:(d + 1) * chunk].copy()) for d in range(n_dev)]
    got = rag.ring_all_gather_plain(chunks)
    for d in range(n_dev):
        assert torch.equal(got[d], torch.from_numpy(words)), f"shard {d}"


def test_ring_rejects_bad_chunks():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        rag.ring_all_gather([x, x.to(torch.int64)])
    with pytest.raises(ValueError, match="one length"):
        rag.ring_all_gather([x, x[:3]])
    with pytest.raises(ValueError, match="at least one shard"):
        rag.ring_all_gather([])
    with pytest.raises(ValueError, match="at most"):
        rag.ring_all_gather([x] * (rag.MAX_SHARDS + 1))
