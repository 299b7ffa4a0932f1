"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled on its own by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, and loaded with ``ctypes``. Every C
entry takes raw device pointers plus the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; the Python wrappers raise when it is not 0.

Libraries land in ``stl_fusion_tpu_torch/_build/`` (git-ignored), keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads straight away. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Host libraries (``HOST_LIBS``: the graph packer ``csrc/graphpack.cpp``) are
plain C++ built the same way with the host compiler (``g++ -O3 -shared
-fPIC``) by :func:`load_host`, which raises when the build fails: no caller
falls back quietly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["HOST_LIBS", "KERNELS", "build_all", "build_info", "entry", "launch", "load",
           "load_host"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: kernel → (source file, {C entry: its argument types}); one library per source
KERNELS: Dict[str, tuple] = {
    # the arguments packed as 12 int64 (``LaunchArgs``), then the stream
    "or_popcount": ("or_popcount.cu", {"or_popcount_launch": [ctypes.c_char_p, _P]}),
    "wave_expand": ("wave_expand.cu", {
        "wave_expand_launch": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
        "wave_expand_merge_launch": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P],
        # the shard table is a DEVICE array of int64[n, 8] rows
        "wave_expand_shards_launch": [_P, _LL, _P, _I, _LL, _P, _LL, _P, _P],
    }),
    "ring_all_gather": ("ring_all_gather.cu", {
        "ring_all_gather_rows_launch": [_P, _LL, _P, _I, _LL, _P],
        # the pointer table is a HOST array of n device pointers
        "ring_all_gather_table_launch": [_P, _P, _I, _LL, _P],
    }),
    # level_starts is a HOST int64 array; the last pointer a host int (launches made)
    "topo_sweep": ("topo_sweep.cu", {
        "topo_sweep_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I,
                              _P, _P],
    }),
    # the row map may be null (the identity); the last pointer before the
    # stream is a host int (launches made)
    "lane_finish": ("lane_finish.cu", {
        "lane_finish_launch": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _P, _P],
    }),
    "block_refresh": ("block_refresh.cu", {
        "block_refresh_launch": [_P, _P, _P, _P, _LL, _LL, _LL, _I, _P],
    }),
    "packed_pull": ("packed_pull.cu", {
        "packed_pull_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL,
                               _I, _I, _I, _I, _P],
    }),
    # the arguments packed as int64 (``LevelArgs``: 26, ``SeedArgs``: 8), then the stream
    "routed_level": ("routed_level.cu", {
        "routed_level_launch": [ctypes.c_char_p, _P],
        "routed_seed_launch": [ctypes.c_char_p, _P],
    }),
}

#: host library → (source file, {C entry: (argument types, result type)})
HOST_LIBS: Dict[str, tuple] = {
    "graphpack": ("graphpack.cpp", {
        "gp_build_ell": ([_P, _P, _LL, _LL, _I, _I], _P),
        "gp_n_tot": ([_P], _LL),
        "gp_fill_out": ([_P, _P, _I], _I),
        "gp_free": ([_P], None),
        "gp_topo_levels": ([_P, _LL, _I, _P], _I),
    }),
}

HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: {"seconds", "registers", "spill_bytes", "cached"} of the last build
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{h[:16]}.so"


def _ptxas_stats(text: str) -> dict:
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    return {"registers": max(regs) if regs else None,
            "spill_bytes": sum(spills) if spills else None}


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together. Raises with the compiler's output if one fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            build_info.setdefault(name, {"seconds": 0.0, "registers": None,
                                         "spill_bytes": None, "cached": True})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            **_ptxas_stats(text), "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: build_info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in KERNELS[name][1].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def entry(name: str, entry: str):
    """The bound ``ctypes`` function of C entry ``entry`` of kernel
    ``name`` (built and loaded first if needed), for a wrapper that resolves
    it once and passes the stream itself: :func:`launch` looks the library,
    the entry and the device up on every call."""
    return getattr(load(name), entry)


def launch(name: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of kernel ``name`` on the current device's
    current stream; raise on a nonzero CUDA error code."""
    import torch

    # the raw handle: torch.cuda.current_stream() builds a Stream object per
    # call, which costs more host time than the launch itself
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = getattr(load(name), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: {entry} failed with CUDA error {err}")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``HOST_LIBS``), compiled with
    ``g++`` into ``_build/`` first if needed. Raises when it cannot be
    built or loaded."""
    lib = _libs.get("host:" + name)
    if lib is not None:
        return lib
    source, entries = HOST_LIBS[name]
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{name}_host_{h[:16]}.so"
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"{name}: no host C++ compiler (g++) to build {source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # the pid and the thread: a background mirror rebuild may build it too
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        build_info["host:" + name] = {"seconds": time.perf_counter() - t0, "cached": False}
    lib = ctypes.CDLL(str(out))
    for entry, (argtypes, restype) in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = restype
    _libs["host:" + name] = lib
    return lib
