"""The port stands alone: no module of ``stl_fusion_tpu_torch`` imports
``jax`` or ``stl_fusion_tpu`` (compared by exact ROOT module name — the
port's own name starts with the string ``stl_fusion_tpu``), and its entry
points raise on a machine with no CUDA device unless ``device="cpu"`` is
passed."""
import torch_threads  # noqa: F401 — one torch thread a test process
import ast
from pathlib import Path

import pytest
import torch

import stl_fusion_tpu_torch
from stl_fusion_tpu_torch.core import FusionHub
from stl_fusion_tpu_torch.device import resolve_device
from stl_fusion_tpu_torch.graph import DeviceGraph, TpuGraphBackend
from stl_fusion_tpu_torch.parallel import graph_mesh

PKG = Path(stl_fusion_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "stl_fusion_tpu"}


def _import_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [f"{f.relative_to(PKG)}:{line} imports {root}"
           for f in files for line, root in _import_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_root_name_check_is_exact(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import stl_fusion_tpu_torch.ops\nfrom stl_fusion_tpu.core import x\n"
                     "from . import y\nimport jax.numpy as jnp\n")
    roots = [r for _, r in _import_roots(probe)]
    assert roots == ["stl_fusion_tpu_torch", "stl_fusion_tpu", "jax"]
    assert [r for r in roots if r in FORBIDDEN] == ["stl_fusion_tpu", "jax"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceGraph()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TpuGraphBackend(FusionHub())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceGraph(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_mesh(8)


def test_explicit_cpu_runs():
    assert resolve_device("cpu") == torch.device("cpu")
    g = DeviceGraph(device="cpu")
    g.add_nodes(3)
    g.add_edges([0, 1], [1, 2])
    assert g.run_wave([0]) == 3


def test_scan_covers_the_mirror_modules_and_the_packer_is_the_ports_own():
    """The import scan reaches every module of the topo and lat slice, and
    the host graph packer the port builds is its own source under
    ``stl_fusion_tpu_torch/csrc`` (no path into the JAX package's
    ``native/``)."""
    from stl_fusion_tpu_torch.ops import _build

    scanned = {f.relative_to(PKG).as_posix() for f in PKG.rglob("*.py")}
    assert {"ops/pull_wave.py", "ops/ell_wave.py", "ops/topo_wave.py", "bench.py"} <= scanned
    src = _build.CSRC / _build.HOST_LIBS["graphpack"][0]
    assert src.is_file() and not src.is_symlink()
    assert src.resolve().parent == (PKG / "csrc").resolve()
    text = src.read_text()
    for entry in _build.HOST_LIBS["graphpack"][1]:
        assert f" {entry}(" in text, entry
    for f in PKG.rglob("*.py"):
        assert "native" not in {root for _, root in _import_roots(f)}
        assert "stl_fusion_tpu/native" not in f.read_text(), f


def test_scan_covers_the_row_block_slice():
    """The import scan reaches the columnar slice: ``state/``, the memo
    table and its bridge, the block refresh and the live twin, and the
    block refresh kernel's source is the port's own."""
    from stl_fusion_tpu_torch.ops import _build

    scanned = {f.relative_to(PKG).as_posix() for f in PKG.rglob("*.py")}
    assert {"state/state.py", "state/mutable.py", "state/computed_state.py", "state/delayer.py",
            "state/factory.py", "ops/memo_table.py", "ops/memo_bridge.py",
            "ops/block_refresh.py", "live_path.py"} <= scanned
    src = _build.CSRC / _build.KERNELS["block_refresh"][0]
    assert src.is_file() and src.resolve().parent == (PKG / "csrc").resolve()


def test_scan_covers_the_resident_live_loop_slice():
    """The import scan reaches the resident live loop: the pipeline, the
    super-rounds and the resident programs, and none of them imports JAX
    or the JAX package."""
    scanned = {f.relative_to(PKG).as_posix() for f in PKG.rglob("*.py")}
    new = {"graph/nonblocking.py", "graph/superround.py", "graph/program_cache.py"}
    assert new <= scanned
    for rel in new:
        roots = {root for _line, root in _import_roots(PKG / rel)}
        assert roots and not roots & FORBIDDEN, (rel, roots)


def test_scan_covers_the_edge_tier_slice():
    """The import scan reaches the edge tier: the gateway and the session
    middleware, ``ext/`` and ``edge/``, and the edge twin."""
    scanned = {f.relative_to(PKG).as_posix() for f in PKG.rglob("*.py")}
    new = {"rpc/http_gateway.py", "rpc/middleware.py", "edge_path.py"} | {
        f"ext/{m}.py" for m in ("__init__", "auth", "fusion_time", "kv_store", "multitenancy",
                                "peer_monitor", "plugins", "server_auth", "session", "streams")
    } | {f"edge/{m}.py" for m in ("__init__", "admission", "gateway", "server", "session",
                                  "worker_pool")}
    assert new <= scanned
    for rel in new:
        roots = {root for _line, root in _import_roots(PKG / rel)}
        assert not roots & FORBIDDEN, (rel, roots)


def test_edge_worker_entry_imports_no_package_and_no_torch():
    """``edge/worker_pool.py`` runs as ``python worker_pool.py --worker``: the
    script's top level imports only the standard library, and every import
    of the package lies in the parent's ``EdgeWorkerPool``, never in the
    worker's code. Run as a script, it loads neither the package nor
    ``torch``, ``numpy`` or JAX."""
    import subprocess
    import sys

    path = PKG / "edge" / "worker_pool.py"
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            assert not (isinstance(node, ast.ImportFrom) and node.level), node.lineno
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            assert not {n.split(".")[0] for n in names} & {"torch", "numpy", *FORBIDDEN}
        for sub in ast.walk(node):
            if isinstance(sub, ast.ImportFrom) and sub.level:
                assert isinstance(node, ast.ClassDef) and node.name == "EdgeWorkerPool", (
                    f"worker_pool.py:{sub.lineno} imports the package outside EdgeWorkerPool")
    probe = ("import runpy, sys\n"
             "sys.argv = ['worker_pool.py']\n"
             "try:\n"
             f"    runpy.run_path({str(path)!r}, run_name='__main__')\n"
             "except SystemExit:\n"
             "    pass\n"
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'numpy', 'jax', "
             "'stl_fusion_tpu', 'stl_fusion_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=60, check=True)
    assert out.stdout.strip() == "[]", out


def test_scan_covers_the_diagnostics_and_resilience_slice():
    """The import scan reaches diagnostics and resilience, the UI and the
    read twin; none names JAX, and the mesh telemetry's host index comes
    from ``torch.distributed`` (0 with no process group)."""
    from stl_fusion_tpu_torch.diagnostics import mesh_telemetry

    scanned = {f.relative_to(PKG).as_posix() for f in PKG.rglob("*.py")}
    new = {f"resilience/{m}.py" for m in ("chaos", "breaker", "watchdog")} | {
        f"diagnostics/{m}.py" for m in ("invariants", "auditor", "slo", "mesh_telemetry",
                                        "explain", "monitor")
    } | {f"ui/{m}.py" for m in ("__init__", "action_tracker", "auth_state", "live_component",
                                "web")} | {"read_throughput.py"}
    assert new <= scanned
    for rel in new:
        roots = {root for _line, root in _import_roots(PKG / rel)}
        assert not roots & FORBIDDEN, (rel, roots)
        text = (PKG / rel).read_text()
        assert "import jax" not in text and "jax." not in text, rel
    mesh_telemetry._host_cache = None
    assert mesh_telemetry.local_host() == "h0"
