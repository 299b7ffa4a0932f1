"""Mesh helpers — the device layout the sharded graph runs on.

Port of ``stl_fusion_tpu/parallel/mesh.py``. JAX shards the graph over a
``jax.sharding.Mesh`` and runs each shard's body under ``shard_map``; the
port's :class:`Mesh` is a tuple of ``torch.device``s, one per **logical
shard**, and a Python loop over the shards takes the place of
``shard_map`` (there is no ``shard_map_compat``).

A device may repeat: ``graph_mesh(devices=["cuda:0"] * 8)`` is eight
logical shards on one card, each with its own buffers, the counterpart of
the JAX package's 8 virtual CPU devices. A mesh whose shards span more than
one card raises: a ring across cards needs peer memory over NVLink
(ROADMAP A.10), and quietly running such a mesh on one card would report
one-card numbers as multi-card ones.

A mesh has a shape over named axes: 1-D over ``graph`` by default, or the
routed wave's two-level ``(host, ldev)`` shape for its ``hier`` exchange
(:meth:`Mesh.reshaped`, JAX's ``devices.reshape(n_hosts, dph)`` over
``(HOST_AXIS, LDEV_AXIS)``): the same logical shards, grouped into hosts.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

__all__ = ["GRAPH_AXIS", "Mesh", "graph_mesh"]

GRAPH_AXIS = "graph"

_MULTI_CARD = "ROADMAP A.10 (multi-card mesh)"


class Mesh:
    """A mesh of logical shards, all on one device: 1-D over the graph axis
    unless ``shape`` and ``axis_names`` say otherwise (row-major over
    ``devices``)."""

    def __init__(self, devices: Sequence[torch.device], shape: Optional[Tuple[int, ...]] = None,
                 axis_names: Tuple[str, ...] = (GRAPH_AXIS,)):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.shape: Tuple[int, ...] = (len(self.devices),) if shape is None else tuple(shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} over {self.axis_names} does not tile "
                             f"{len(self.devices)} shards")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"a mesh over {sorted(map(str, set(self.devices)))} spans more than one "
                f"device; only one-card meshes are ported: {_MULTI_CARD}"
            )

    @property
    def size(self) -> int:
        """Shard count (the JAX code reads ``mesh.devices.size``)."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]

    def reshaped(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]) -> "Mesh":
        """The same shards under another shape and axis names."""
        return Mesh(self.devices, shape, axis_names)


def graph_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Mesh:
    """1-D mesh over the graph axis. An explicit ``devices`` list wins
    (repeats allowed: each entry is one shard); otherwise ``n_devices``
    shards (default 1) on :func:`~stl_fusion_tpu_torch.device.resolve_device`
    of ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        devs = [resolve_device(device)] * (1 if n_devices is None else n_devices)
    # "cuda" and "cuda:0" name one card; compare by index
    devs = [
        torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else d
        for d in devs
    ]
    return Mesh(devs)
