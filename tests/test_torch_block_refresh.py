"""Parity of the row block's refresh with the JAX package's refresh program
(``TpuGraphBackend.refresh_block_on_device``): the same numpy-made table
values, validity, loader rows and graph invalid state (bits inside and
outside the block, on both sides of unaligned ends) go through JAX's
backend and through the port's plain ``block_refresh`` on packed words, and
then through the port's backend. Bases 0 and 37, row shapes ``()`` and
``(3,)``, float32 and int32, ``update_valid`` both ways. Values, validity,
the invalid bits (those outside the block unchanged) and the host
bookkeeping must be EQUAL. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.graph as jgraph
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.graph as pgraph
from stl_fusion_tpu.ops.memo_table import MemoTable as JaxTable
from stl_fusion_tpu_torch.ops import block_refresh as br
from stl_fusion_tpu_torch.ops.bitops import pack_mask_host, unpack_words_host
from stl_fusion_tpu_torch.ops.memo_table import MemoTable as PortTable

N_ROWS, N_AFTER = 100, 20


def _inputs(base, row_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    n_all = base + N_ROWS + N_AFTER
    values = rng.integers(-99, 99, size=(N_ROWS, *row_shape)).astype(dtype)
    fresh = rng.integers(1000, 2000, size=(N_ROWS, *row_shape)).astype(dtype)
    valid = rng.random(N_ROWS) < 0.5
    invalid = np.zeros(n_all, bool)
    invalid[rng.choice(n_all, n_all // 3, replace=False)] = True
    invalid[[base, base + N_ROWS - 1]] = True  # the block's first and last rows
    if base:
        invalid[base - 1] = True  # the bit just before the block
    invalid[base + N_ROWS] = True  # and just after it
    return values, fresh, valid, invalid


def _run_backend(pkg, base, row_shape, dtype, inputs, update_valid):
    """One refresh through a package's backend: nodes [0, base) first, the
    block of N_ROWS, then N_AFTER nodes; the invalid marks on all of them."""
    core, graph, Table, kw, to_dev = pkg
    values, fresh, valid, invalid = inputs
    hub = core.FusionHub()
    backend = graph.TpuGraphBackend(hub, node_capacity=256, edge_capacity=64, **kw)
    if base:
        backend.graph.add_nodes(base)
        backend._ensure_host_masks()
    table = Table(N_ROWS, lambda ids: fresh[np.asarray(ids)], row_shape=row_shape, dtype=dtype,
                  **kw)
    block = backend.bind_table_rows(table)
    backend.graph.add_nodes(N_AFTER)
    backend._ensure_host_masks()
    table.import_state({"values": values, "valid": valid, "version": 3})
    fresh_dev = to_dev(fresh)
    table.device_compute_fn = lambda ids, f: f[ids]
    table.device_loader_args = lambda: (fresh_dev,)
    if not update_valid:
        table._valid_dev_dirty = True  # a full materialization is pending
    backend.graph.mark_invalid(np.nonzero(invalid)[0].astype(np.int32))
    stale_before = table._stale_host.copy()
    n = backend.refresh_block_on_device(block)
    return {
        "refreshed": n,
        "values": np.array(table._values.cpu() if isinstance(table._values, torch.Tensor)
                           else table._values),
        "valid_raw": np.array(table._valid_dev.cpu() if isinstance(table._valid_dev, torch.Tensor)
                              else table._valid_dev),
        "stale": table._stale_host.copy(),
        "stale_before": stale_before,
        "stale_count": table.stale_count(),
        "version": table.version,
        "invalid": backend.graph.invalid_mask(),
        "h_invalid": backend.graph._h_invalid[: base + N_ROWS + N_AFTER].copy(),
        "invalid_version_moved": backend.graph.invalid_version,
    }


JAX = (jcore, jgraph, JaxTable, {}, jnp.asarray)
PORT = (pcore, pgraph, PortTable, {"device": "cpu"}, torch.from_numpy)


@pytest.mark.parametrize("base", [0, 37])
@pytest.mark.parametrize("row_shape", [(), (3,)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("update_valid", [True, False])
def test_block_refresh_matches_jax_refresh_program(base, row_shape, dtype, update_valid):
    inputs = _inputs(base, row_shape, dtype, seed=base + len(row_shape) * 7)
    values, fresh, valid, invalid = inputs
    want = _run_backend(JAX, base, row_shape, dtype, inputs, update_valid)

    # the plain version on packed words, straight from the same state
    n_all = len(invalid)
    words = torch.from_numpy(pack_mask_host(invalid))
    tv = torch.from_numpy(values.copy())
    tvalid = torch.from_numpy(valid.copy())
    br.block_refresh(words, tv, torch.from_numpy(fresh), tvalid if update_valid else None, base)
    np.testing.assert_array_equal(tv.numpy(), want["values"])
    if update_valid:
        np.testing.assert_array_equal(tvalid.numpy(), want["valid_raw"])
    else:
        np.testing.assert_array_equal(tvalid.numpy(), valid)
    after = unpack_words_host(words.numpy(), len(words) * 32)
    np.testing.assert_array_equal(after[:n_all], want["invalid"][:n_all])
    outside = np.ones(len(after), bool)
    outside[base: base + N_ROWS] = False
    np.testing.assert_array_equal(after[outside][:n_all - N_ROWS], invalid[outside[:n_all]])
    assert not after[base: base + N_ROWS].any()
    assert want["refreshed"] == int(invalid[base: base + N_ROWS].sum())

    # and the whole refresh through the port's backend
    got = _run_backend(PORT, base, row_shape, dtype, inputs, update_valid)
    for key in want:
        if key == "invalid_version_moved":
            continue
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_block_refresh_checks_its_arguments():
    words = torch.zeros(4, dtype=torch.int32)
    vals = torch.zeros(10)
    with pytest.raises(ValueError, match="fresh"):
        br.block_refresh(words, vals, torch.zeros(10, dtype=torch.int32), None, 0)
    with pytest.raises(ValueError, match="outside"):
        br.block_refresh(words, vals, torch.zeros(10), None, 120)
    with pytest.raises(ValueError, match="valid"):
        br.block_refresh(words, vals, torch.zeros(10), torch.zeros(9, dtype=torch.bool), 0)
    before = br.launches
    br.block_refresh(words, vals, torch.zeros(10), None, 3)  # the CPU: plain, no launch
    assert br.launches == before
