"""Device meshes: the JAX package's axis names on ``torch.distributed``.

``make_mesh(shape, axes)`` lays the process group's ranks out as a
``DeviceMesh`` (``init_device_mesh``) and wraps it in :class:`Mesh`, whose
``.shape`` is the ordered axis -> size mapping that JAX's ``Mesh.shape`` is
and that the partitioning rules read (``runtime.partitioning``,
``runtime.sharding_rules``). A mesh spans every rank of the default
process group: its size must equal the world size, or the call raises (it
never shrinks or pads). Meshes live on the card unless the caller asks for
``device_type="cpu"`` (a ``gloo`` group). These are functions: importing
this module touches no device and no process group.
"""
from __future__ import annotations

import math
import os
import socket
import types

import torch
import torch.distributed as dist


class Mesh:
    """A ``DeviceMesh`` with the JAX mesh's view: ``.shape`` (axis -> size,
    in axis order), ``.axis_names``, ``.size``; the ``DeviceMesh`` itself
    is ``.device_mesh``."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = types.MappingProxyType(dict(zip(self.axis_names, device_mesh.shape)))
        self.size = math.prod(device_mesh.shape)

    def get_group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def rank_in(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)

    def sub(self, axes: tuple[str, ...]) -> "Mesh":
        """The sub-mesh over ``axes`` that holds this rank."""
        return Mesh(self.device_mesh[tuple(axes)])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)!r}, {self.device_mesh.device_type!r})"


def _device_type(device_type) -> str:
    dt = device_type or "cuda"
    if dt == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; meshes live on the card unless given device_type='cpu'")
    return dt


def init_process_group(device_type=None, *, world_size: int = 1) -> None:
    """Join the default process group unless it exists: from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``) when
    set, else as the only rank of a group of one on a free local port
    (``world_size`` must then be 1). NCCL on the card, gloo on the CPU."""
    if dist.is_initialized():
        return
    dt = _device_type(device_type)
    backend = "nccl" if dt == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dt == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])) % torch.cuda.device_count())
        dist.init_process_group(backend)
        return
    if world_size != 1:
        raise RuntimeError(f"a mesh of {world_size} ranks needs a process group of {world_size}; "
                           "start the ranks with torchrun (python -m torch.distributed.run)")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if dt == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    process group (which must exist, with ``prod(shape)`` ranks)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dt = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group (launch.mesh.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh has {math.prod(shape)} ranks, the process group {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(dt, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None) -> Mesh:
    """16x16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)
