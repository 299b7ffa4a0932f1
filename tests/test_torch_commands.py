"""Parity of the port's command pipeline and operations framework
(``stl_fusion_tpu_torch/commands``, ``operations``) with the JAX package's:
the 8 cases of ``tests/test_commands.py`` (dispatch, filter order, a
missing handler, the transient-error reprocessor, HelloCart v1 end to end
and its change watch, nested command replay and the top-level opt-out),
each run as one scenario through both packages on a fresh hub with the
operations pipeline attached, with the reference's assertions, and their
observations (results, filter traces, retry counts, totals, recompute
counts) required EQUAL. Tolerance: exact."""
import torch_threads  # noqa: F401 — one torch thread a test process
import asyncio
from dataclasses import dataclass
from typing import Dict, List, Optional

import pytest

import stl_fusion_tpu.commands as jcommands
import stl_fusion_tpu.core as jcore
import stl_fusion_tpu.utils as jutils
import stl_fusion_tpu_torch.commands as pcommands
import stl_fusion_tpu_torch.core as pcore
import stl_fusion_tpu_torch.utils as putils

PKGS = {"jax": (jcore, jcommands, jutils), "port": (pcore, pcommands, putils)}


async def both(scenario):
    """Run ``scenario(core, commands, utils, hub)`` on each package on a
    fresh default hub with the operations pipeline attached; the
    observations must be equal."""
    got = []
    for core, commands, utils in PKGS.values():
        hub = core.FusionHub()
        hub.commander.attach_operations_pipeline()
        old = core.set_default_hub(hub)
        try:
            got.append(await scenario(core, commands, utils, hub))
        finally:
            core.set_default_hub(old)
    assert got[0] == got[1], got
    return got[1]


@dataclass(frozen=True)
class Greet:
    name: str


@dataclass(frozen=True)
class Product:
    id: str
    price: float


@dataclass(frozen=True)
class Cart:
    id: str
    item_ids: tuple


@dataclass(frozen=True)
class EditProduct:
    product: Product


@dataclass(frozen=True)
class EditBoth:
    a: Product
    b: Product


@dataclass(frozen=True)
class OptOutEditBoth:
    __requires_invalidation__ = False
    a: Product
    b: Product


def hello_cart(core, commands):
    """HelloCart v1's ProductService and CartService on ``core``."""

    class ProductService(core.ComputeService):
        def __init__(self, hub=None):
            super().__init__(hub)
            self._products: Dict[str, Product] = {}

        @core.compute_method
        async def get(self, product_id: str) -> Optional[Product]:
            return self._products.get(product_id)

        @commands.command_handler
        async def edit(self, command: EditProduct) -> None:
            if core.is_invalidating():
                await self.get(command.product.id)
                return
            self._products[command.product.id] = command.product

    class CartService(core.ComputeService):
        def __init__(self, products, hub=None):
            super().__init__(hub)
            self.products = products
            self._carts: Dict[str, Cart] = {}
            self.total_computes = 0

        def add_cart(self, cart: Cart):
            self._carts[cart.id] = cart

        @core.compute_method
        async def get_total(self, cart_id: str) -> float:
            self.total_computes += 1
            cart = self._carts.get(cart_id)
            if cart is None:
                return 0.0
            total = 0.0
            for pid in cart.item_ids:
                p = await self.products.get(pid)
                if p is not None:
                    total += p.price
            return total

    return ProductService, CartService


async def test_basic_command_dispatch():
    async def run(core, commands, utils, hub):
        class Svc:
            @commands.command_handler
            async def greet(self, command: Greet) -> str:
                return f"hello {command.name}"

        hub.commander.add_service(Svc())
        result = await hub.commander.call(Greet("tpu"))
        assert result == "hello tpu"
        return result
    await both(run)


async def test_filter_ordering():
    async def run(core, commands, utils, hub):
        trace = []

        class Svc:
            @commands.command_filter(priority=10)
            async def outer(self, command: Greet, context):
                trace.append("outer-in")
                r = await context.invoke_remaining_handlers()
                trace.append("outer-out")
                return r

            @commands.command_filter(priority=5)
            async def inner(self, command: Greet, context):
                trace.append("inner-in")
                r = await context.invoke_remaining_handlers()
                trace.append("inner-out")
                return r

            @commands.command_handler
            async def run(self, command: Greet) -> str:
                trace.append("handler")
                return command.name

        hub.commander.add_service(Svc())
        result = await hub.commander.call(Greet("x"))
        pattern = ["outer-in", "inner-in", "handler", "inner-out", "outer-out"]
        assert result == "x" and trace == pattern * 2
        return result, trace
    await both(run)


async def test_missing_handler_raises():
    async def run(core, commands, utils, hub):
        with pytest.raises(LookupError) as e:
            await hub.commander.call(Greet("nobody"))
        return str(e.value)
    await both(run)


async def test_transient_error_retry():
    async def run(core, commands, utils, hub):
        attempts = []

        class Svc:
            @commands.command_handler
            async def flaky(self, command: Greet) -> str:
                if core.is_invalidating():
                    return "done"
                attempts.append(1)
                if len(attempts) < 3:
                    raise utils.TransientError("not yet")
                return "done"

        hub.commander.add_service(Svc())
        result = await hub.commander.call(Greet("retry"))
        assert result == "done" and len(attempts) == 3
        return result, len(attempts)
    await both(run)


async def test_hello_cart_end_to_end():
    async def run(core, commands, utils, hub):
        ProductService, CartService = hello_cart(core, commands)
        products = ProductService()
        carts = CartService(products)
        hub.commander.add_service(products)
        await hub.commander.call(EditProduct(Product("apple", 2.0)))
        await hub.commander.call(EditProduct(Product("banana", 1.0)))
        carts.add_cart(Cart("c1", ("apple", "banana")))
        seen = [await carts.get_total("c1"), await carts.get_total("c1"), carts.total_computes]
        await hub.commander.call(EditProduct(Product("apple", 5.0)))
        total_node = await core.get_existing(lambda: carts.get_total("c1"))
        seen.append(total_node is None or total_node.is_invalidated)
        seen += [await carts.get_total("c1"), carts.total_computes]
        assert seen == [3.0, 3.0, 1, True, 6.0, 2]
        return seen
    await both(run)


async def test_hello_cart_changes_watch_loop():
    async def run(core, commands, utils, hub):
        ProductService, CartService = hello_cart(core, commands)
        products = ProductService()
        carts = CartService(products)
        hub.commander.add_service(products)
        await hub.commander.call(EditProduct(Product("apple", 2.0)))
        carts.add_cart(Cart("c1", ("apple",)))
        totals: List[float] = []

        async def watch():
            c = await core.capture(lambda: carts.get_total("c1"))
            async for snapshot in c.changes():
                totals.append(snapshot.output.value)
                if len(totals) == 3:
                    return

        task = asyncio.ensure_future(watch())
        await asyncio.sleep(0.02)
        await hub.commander.call(EditProduct(Product("apple", 10.0)))
        await asyncio.sleep(0.02)
        await hub.commander.call(EditProduct(Product("apple", 20.0)))
        await asyncio.wait_for(task, 2.0)
        assert totals == [2.0, 10.0, 20.0]
        return totals
    await both(run)


async def test_nested_command_replay():
    async def run(core, commands, utils, hub):
        ProductService, CartService = hello_cart(core, commands)
        products = ProductService()
        carts = CartService(products)

        class BulkService(core.ComputeService):
            @commands.command_handler
            async def edit_both(self, command: EditBoth, context) -> None:
                if core.is_invalidating():
                    return
                await hub.commander.call(EditProduct(command.a))
                await hub.commander.call(EditProduct(command.b))

        hub.commander.add_service(products)
        hub.commander.add_service(BulkService())
        await hub.commander.call(EditProduct(Product("x", 1.0)))
        await hub.commander.call(EditProduct(Product("y", 1.0)))
        carts.add_cart(Cart("c", ("x", "y")))
        seen = [await carts.get_total("c")]
        await hub.commander.call(EditBoth(Product("x", 3.0), Product("y", 4.0)))
        seen += [await carts.get_total("c"), carts.total_computes]
        assert seen[:2] == [2.0, 7.0]
        return seen
    await both(run)


async def test_nested_replay_survives_top_level_opt_out():
    async def run(core, commands, utils, hub):
        ProductService, CartService = hello_cart(core, commands)
        products = ProductService()
        carts = CartService(products)

        class BulkService(core.ComputeService):
            @commands.command_handler
            async def edit_both(self, command: OptOutEditBoth, context) -> None:
                await hub.commander.call(EditProduct(command.a))
                await hub.commander.call(EditProduct(command.b))

        hub.commander.add_service(products)
        hub.commander.add_service(BulkService())
        await hub.commander.call(EditProduct(Product("x", 1.0)))
        await hub.commander.call(EditProduct(Product("y", 1.0)))
        carts.add_cart(Cart("c", ("x", "y")))
        seen = [await carts.get_total("c")]
        await hub.commander.call(OptOutEditBoth(Product("x", 3.0), Product("y", 4.0)))
        seen += [await carts.get_total("c"), carts.total_computes]
        assert seen[:2] == [2.0, 7.0]
        return seen
    await both(run)


async def test_requires_invalidation_skips_remote_proxy_handlers():
    """A command whose final handler is a ``compute_client`` proxy method
    (``__fusion_remote_proxy__``) is replayed by its owning host, not here:
    ``requires_invalidation`` is False for it and True for a local handler,
    in both packages (JAX ``operations/pipeline.py:85-101``)."""
    import stl_fusion_tpu.client as jclient
    import stl_fusion_tpu.rpc as jrpc
    import stl_fusion_tpu_torch.client as pclient
    import stl_fusion_tpu_torch.rpc as prpc

    async def run(core, commands, utils, hub):
        client_mod, rpc_mod = (jclient, jrpc) if core is jcore else (pclient, prpc)
        ProductService, _ = hello_cart(core, commands)
        products = ProductService()
        rpc_hub = rpc_mod.RpcHub("client")
        client_mod.install_compute_call_type(rpc_hub)
        proxy = client_mod.compute_client("products", rpc_hub, hub)
        router = client_mod.RoutingComputeProxy("products", rpc_hub, hub)
        hub.commander.add_handler(proxy.edit, command_type=EditProduct)
        hub.commander.add_handler(router.edit, command_type=EditBoth)
        hub.commander.add_handler(products.edit, command_type=Greet)
        info = hub.commander.operations.invalidation_info
        seen = [info.requires_invalidation(c) for c in (
            EditProduct(Product("x", 1.0)), EditBoth(Product("x", 1.0), Product("y", 2.0)),
            Greet("local"), OptOutEditBoth(Product("x", 1.0), Product("y", 2.0)))]
        assert seen == [False, False, True, False]
        return seen
    await both(run)
