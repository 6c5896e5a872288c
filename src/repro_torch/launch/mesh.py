"""Mesh construction: the abstract production mesh and the host mesh.

``make_production_mesh`` is the JAX package's TPU topology as axis names
and sizes only (no devices): v5e pods of 256 chips as (16, 16) =
(data, model), and a leading 'pod' axis for 2 x 256 = 512 chips. The dry
run (``launch.dryrun``) computes its shardings against it; the spec
functions of ``distributed.sharding`` read nothing else of a mesh.

``make_host_mesh`` is a real ``torch.distributed.device_mesh.DeviceMesh``
over the devices of this process group. Importing this module touches no
device and starts no process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes without devices."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes, strict=True))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def _ensure_process_group(device_type: str) -> None:
    """A single-process group when none exists: NCCL on the card, gloo on
    the CPU, over an in-process store (no environment variables, no
    network)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(
    shape: tuple[int, ...] = (1, 1),
    axes: tuple[str, ...] = ("data", "model"),
    *,
    device: str = "cuda",
):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group's devices, on the card by default (``device="cpu"``: gloo on
    the CPU). Starts a single-process group if none exists. A shape whose
    product is not the world size raises ``ValueError``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA "
                           "device (torch.cuda.is_available() is false)")
    _ensure_process_group(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} spans "
                         f"{math.prod(shape)} devices; the process group "
                         f"has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axes))
