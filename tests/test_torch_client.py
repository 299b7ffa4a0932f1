"""Parity of the port's client layer (``stl_fusion_tpu_torch/client``: the
``$sys-c`` compute calls, ``FusionClient`` and its client computeds, the
client caches, the service modes and the router proxy, and
``RemoteTableHost``/``RemoteTable`` over the port's ``MemoTable``) with
the JAX package's.

Each case runs one reference test of ``tests/test_fusion_rpc.py``,
``tests/test_service_modes.py`` or ``tests/test_remote_table.py`` on both
packages (``test_torch_rpc.run_both``): the reference's assertions hold on
both runs, and every outbound call's first result, every call error and,
where the traffic does not depend on timing, each hub's counters must be
EQUAL. The port's memo tables and graph backends run on the CPU
(``device="cpu"``), so each remote read crosses from the table's tensor to
the wire's ndarray as it does on the card. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio

import numpy as np
import pytest

from test_torch_rpc import run_both

FUSION_RPC = [
    "test_remote_compute_memoizes_client_side", "test_server_invalidation_pushes_to_client",
    "test_client_graph_cascades_from_remote_dependency", "test_remote_error_memoized_and_raised",
    "test_client_cache_boots_and_synchronizes",
    "test_result_arriving_already_invalidated_retries_and_converges",
    "test_invalidate_only_restart_answer_retries",
]
FUSION_RPC_RECONNECTS = [
    "test_compute_call_survives_reconnect", "test_recreated_client_peer_never_reuses_call_ids",
    "test_fusion_client_chaos_no_lost_invalidation",
    "test_invalidation_delivery_under_chaos_dup_reorder_disconnect",
]


@pytest.mark.parametrize("test", FUSION_RPC)
def test_fusion_rpc_case(test, tmp_path):
    run_both("test_fusion_rpc", test, tmp_path=tmp_path)


@pytest.mark.parametrize("test", FUSION_RPC_RECONNECTS)
def test_fusion_rpc_reconnect_case(test, tmp_path):
    run_both("test_fusion_rpc", test, stats=False, tmp_path=tmp_path)


@pytest.mark.parametrize("test", [
    "test_router_mode_routes_by_key_and_memoizes", "test_router_invalidation_pushes_from_owning_shard",
    "test_router_local_fallback", "test_serving_router_gateway_chains_invalidation",
    "test_server_and_local_modes",
])
def test_service_modes_case(test):
    run_both("test_service_modes", test)


REMOTE_TABLE = [
    "test_remote_read_batch_one_rpc_per_stale_batch", "test_server_row_invalidation_flips_remote_result",
    "test_fence_during_inflight_read_wins", "test_fenced_row_revalidates_after_refetch",
    "test_host_and_client_roles_coexist_on_one_hub", "test_concurrent_readers_single_flight",
    "test_command_to_remote_refetch_full_stack", "test_remote_read_keys_server_codec_authoritative",
    "test_remote_keyed_fence_refetches_only_fenced_key",
]
REMOTE_TABLE_RECONNECTS = ["test_reconnect_invalidates_cache_and_resubscribes",
                           "test_remote_keyed_reconnect_relearns_layout"]


@pytest.mark.parametrize("test", REMOTE_TABLE)
def test_remote_table_case(test):
    run_both("test_remote_table", test)


@pytest.mark.parametrize("test", REMOTE_TABLE_RECONNECTS)
def test_remote_table_reconnect_case(test):
    run_both("test_remote_table", test, stats=False)


@pytest.mark.parametrize("chaos_seed", [77, 1, 5])
def test_remote_table_chaos_convergence(chaos_seed):
    run_both("test_remote_table", "test_remote_table_chaos_convergence", stats=False,
             chaos_seed=chaos_seed)


def test_remote_table_host_serves_ndarrays_from_a_tensor_table():
    """The host crosses each read from the table's tensor to the wire's
    ndarray once per RPC (``.cpu().numpy()``), and ``table_info`` reports
    the numpy dtype and row shape: the same payloads as the JAX host's."""
    import stl_fusion_tpu.client as jclient
    import stl_fusion_tpu.ops.memo_table as jmemo
    import stl_fusion_tpu.rpc as jrpc
    import stl_fusion_tpu_torch.client as pclient
    import stl_fusion_tpu_torch.ops.memo_table as pmemo
    import stl_fusion_tpu_torch.rpc as prpc

    def compute(ids):
        ids = np.asarray(ids)
        return np.stack([ids * 2, ids + 1], axis=1).astype(np.int32)

    out = []
    for client, memo, rpc, kw in ((jclient, jmemo, jrpc, {}),
                                  (pclient, pmemo, prpc, {"device": "cpu"})):
        async def run():
            server, reader = rpc.RpcHub("server"), rpc.RpcHub("client")
            rpc.RpcTestTransport(reader, server, wire_codec=True)
            table = memo.MemoTable(16, compute, row_shape=(2,), dtype=np.int32, **kw)
            client.RemoteTableHost(server).expose("t", table)
            service = server.service_registry.require(client.TABLE_RPC_SERVICE)
            info = await service.method("table_info").fn("t")
            batch = await service.method("read_batch").fn("t", np.array([3, 1, 3]))
            remote = client.RemoteTable(reader, "default", "t")
            got = await remote.read_batch(np.arange(16))
            await reader.stop()
            await server.stop()
            assert isinstance(batch["values"], np.ndarray) and isinstance(got, np.ndarray)
            return (info, batch["values"].dtype.str, batch["values"].tolist(), got.tolist(),
                    remote.remote_reads)
        out.append(asyncio.run(run()))
    assert out[0] == out[1], out
