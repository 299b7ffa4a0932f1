"""The port's package exports match the JAX package's: for each ported
subpackage, every name in the reference's ``__all__`` (the top level has
none, so its ``from .x import`` names) whose defining module the port has
must import from the port's package. The reference's defining module of a
name is read from its ``__init__``'s ``from .x import ...`` lines.

Nothing is left out silently: every reference module a ported subpackage
re-exports from but the port lacks is listed in ``UNPORTED_MODULES`` with
its ROADMAP id, every reference subpackage the port lacks is listed in
``UNPORTED_PACKAGES``, and a name the port leaves out although it has the
module would have to be listed in ``LEFT_OUT`` (it is empty)."""
import torch_threads  # noqa: F401 — one torch thread a test process
import ast
import importlib
from pathlib import Path

import pytest

import stl_fusion_tpu
import stl_fusion_tpu_torch

REF = Path(stl_fusion_tpu.__file__).resolve().parent
PORT = Path(stl_fusion_tpu_torch.__file__).resolve().parent

#: reference modules that ported subpackages re-export from, not ported yet
UNPORTED_MODULES = {
    "cluster.membership": "A.9",
    "cluster.mesh_controller": "A.9",
    "cluster.rejoin": "A.9",
    "cluster.multihost": "A.9",
}

#: reference subpackages with no port package yet (``native`` is the host
#: graph packer: the port builds ``csrc/graphpack.cpp`` through
#: ``ops/_build.py::load_host`` instead)
UNPORTED_PACKAGES = {
    "native": "ported as ops/_build.py::load_host",
}

#: (subpackage, name) pairs the port leaves out although it has the module
LEFT_OUT: dict = {}

SUBPACKAGES = sorted(p.name for p in REF.iterdir() if (p / "__init__.py").exists())


def _reexports(init: Path):
    """{name: defining module relative to the package} from ``from .x
    import a, b`` lines of an ``__init__``."""
    out = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
    return out


def _has_module(pkg: str, module: str) -> bool:
    rel = Path(*([pkg] if pkg else []), *module.split("."))
    return (PORT / rel).with_suffix(".py").exists() or (PORT / rel / "__init__.py").exists()


def _expected(pkg: str):
    """(names the port must export, reference modules it lacks)."""
    init = (REF / pkg / "__init__.py") if pkg else REF / "__init__.py"
    where = _reexports(init)
    ref = importlib.import_module("stl_fusion_tpu" + (f".{pkg}" if pkg else ""))
    names = list(getattr(ref, "__all__", where))
    want, missing = [], set()
    for name in names:
        module = where.get(name)  # None: defined in the __init__ itself
        if module is None or _has_module(pkg, module):
            want.append(name)
        else:
            missing.add(f"{pkg}.{module}" if pkg else module)
    return want, missing


def test_every_reference_subpackage_is_ported_or_listed():
    ported = {p.name for p in PORT.iterdir() if (p / "__init__.py").exists()}
    assert sorted(set(SUBPACKAGES) - ported) == sorted(UNPORTED_PACKAGES)
    assert not (set(UNPORTED_PACKAGES) & ported)


@pytest.mark.parametrize("pkg", [""] + [p for p in SUBPACKAGES if p not in UNPORTED_PACKAGES])
def test_port_package_exports_the_reference_names(pkg):
    want, missing = _expected(pkg)
    port = importlib.import_module("stl_fusion_tpu_torch" + (f".{pkg}" if pkg else ""))
    absent = [n for n in want if not hasattr(port, n) and (pkg, n) not in LEFT_OUT]
    assert absent == [], f"stl_fusion_tpu_torch.{pkg} lacks {absent}"
    if hasattr(port, "__all__"):
        assert [n for n in want if n not in port.__all__ and (pkg, n) not in LEFT_OUT] == []
    # a reference module the port lacks must be listed with its slice
    assert missing == {m for m in UNPORTED_MODULES if m.split(".")[0] == pkg}


def test_unported_modules_are_absent_and_named():
    for module, slice_ in UNPORTED_MODULES.items():
        pkg, mod = module.split(".", 1)
        assert not _has_module(pkg, mod), f"{module} is ported: drop it from UNPORTED_MODULES"
        assert slice_.startswith("A.")


def test_write_path_entry_points_are_the_ports(tmp_path):
    import numpy as np

    import stl_fusion_tpu_torch.checkpoint as ckpt
    import stl_fusion_tpu_torch.commands as commands
    from stl_fusion_tpu_torch.cluster import DevicePlacement, ShardMap
    from stl_fusion_tpu_torch.core import FusionHub
    from stl_fusion_tpu_torch.parallel import RoutedShardedGraph, graph_mesh

    hub = FusionHub()
    assert isinstance(hub.commander, commands.Commander)
    assert hub.commander is hub.commander
    assert stl_fusion_tpu_torch.save_graph is ckpt.save_graph
    # the routed mesh (A.9's second part) is ported: its shard state round-trips
    src, dst = np.arange(0, 63), np.arange(1, 64)

    def routed():
        pl = DevicePlacement.build(ShardMap.initial(["a", "b"], n_shards=8), 2, 64)
        return RoutedShardedGraph(src, dst, 64, pl, mesh=graph_mesh(devices=["cpu"] * 2))

    g = routed()
    assert g.run_wave_collect([40])[0] == 24
    path = str(tmp_path / "mesh.npz")
    assert ckpt.save_mesh_shards(g, path) == 8
    g2 = routed()
    assert ckpt.restore_mesh_shards(g2, path) == {"restored": 8, "map_epoch": 0}
    assert np.array_equal(g2.invalid_mask(), g.invalid_mask())
