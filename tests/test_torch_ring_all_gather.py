"""Parity of the port's ring all-gather (``stl_fusion_tpu_torch.ops.ring_all_gather``)
with the JAX package's Pallas ``make_ring_all_gather``, run in interpret mode
under ``shard_map`` on the conftest's 8-device virtual CPU mesh. The port's
mesh is 8 CPU shards fed the same numpy words, as a list of chunks or as the
rows of one 2-D tensor. Tolerance: exact (the words are compared as uint32).
``tests/test_torch_gpu.py`` holds the CUDA kernel against its plain version
on the card."""
import torch_threads  # noqa: F401 — one torch thread a test process
import functools

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


@functools.lru_cache(maxsize=None)
def _jax_ring(chunk):
    """(words, the Pallas ring's output per device as uint32[N_DEV, N_DEV * chunk])."""
    devices = jax.devices()
    assert len(devices) == N_DEV
    words = _words(N_DEV, chunk, chunk)
    mesh = Mesh(np.array(devices), ("graph",))
    ring = make_ring_all_gather("graph")

    @shard_map_compat(mesh=mesh, in_specs=P("graph"), out_specs=P("graph"))
    def gather_ring(w_local):
        return ring(w_local).reshape(N_DEV, -1)

    sharded = jax.device_put(jnp.asarray(words), NamedSharding(mesh, P("graph")))
    return words, np.asarray(gather_ring(sharded)).reshape(N_DEV, N_DEV * chunk)


@pytest.mark.parametrize("chunk", [128, 256])
def test_ring_plain_matches_jax_ring(chunk):
    if not ring_all_gather_supported():
        pytest.skip("jax on this image lacks the ring kernel's APIs")
    words, want = _jax_ring(chunk)
    chunks = [torch.from_numpy(words[d * chunk:(d + 1) * chunk].view(np.int32).copy())
              for d in range(N_DEV)]
    before = rag.launches
    got = rag.ring_all_gather(chunks)  # CPU tensors: the plain version
    assert rag.launches == before  # no kernel launched on the CPU
    assert len(got) == N_DEV
    for d in range(N_DEV):
        np.testing.assert_array_equal(got[d].numpy().view(np.uint32), want[d], err_msg=f"shard {d}")


@pytest.mark.parametrize("chunk,pad", [(128, 3), (256, 128)])
def test_ring_rows_match_jax_ring(chunk, pad):
    """The chunks as rows of one 2-D tensor whose row stride exceeds the
    chunk (the sharded wave's next-frontier rows): the same words as the
    Pallas ring, and the padding words are never read."""
    if not ring_all_gather_supported():
        pytest.skip("jax on this image lacks the ring kernel's APIs")
    words, want = _jax_ring(chunk)
    rows = torch.full((N_DEV, chunk + pad), -1, dtype=torch.int32)
    rows[:, :chunk] = torch.from_numpy(words.view(np.int32).reshape(N_DEV, chunk))
    view = rows[:, :chunk]
    assert view.stride(0) > chunk
    before = (rag.launches, rag.cuda_launches)
    got = rag.ring_all_gather(view)
    assert (rag.launches, rag.cuda_launches) == before
    assert got.shape == (N_DEV, N_DEV * chunk)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n_dev,chunk", [(1, 1), (2, 31), (3, 1), (3, 31), (8, 31)])
def test_ring_plain_equals_concatenation(n_dev, chunk):
    """Any shard count and any whole number of words: every shard ends with
    every chunk in shard order."""
    words = _words(n_dev, chunk, 100 * n_dev + chunk).view(np.int32)
    chunks = [torch.from_numpy(words[d * chunk:(d + 1) * chunk].copy()) for d in range(n_dev)]
    got = rag.ring_all_gather_plain(chunks)
    for d in range(n_dev):
        assert torch.equal(got[d], torch.from_numpy(words)), f"shard {d}"


@pytest.mark.parametrize("n_dev,chunk", [(1, 1), (3, 31), (8, 5)])
def test_ring_plain_rows_equal_concatenation(n_dev, chunk):
    """2-D rows with a row stride past the chunk give what the list gives."""
    words = _words(n_dev, chunk, 7 * n_dev + chunk).view(np.int32)
    rows = torch.zeros(n_dev, chunk + 2, dtype=torch.int32)
    rows[:, :chunk] = torch.from_numpy(words.reshape(n_dev, chunk))
    got = rag.ring_all_gather(rows[:, :chunk])
    want = rag.ring_all_gather_plain(list(rows[:, :chunk]))
    assert torch.equal(got, want)
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
    rows = torch.zeros(3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unit column stride"):
        rag.ring_all_gather(rows[:, ::2])
    with pytest.raises(ValueError, match="2-D int32"):
        rag.ring_all_gather(rows.to(torch.int64))
    with pytest.raises(ValueError, match="at least one word"):
        rag.ring_all_gather(rows[:, :0])
