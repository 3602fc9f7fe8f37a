"""The device mesh on `torch.distributed`, and the topology.

Port of `two_tower_recommender_model_tpu/parallel/mesh.py`. The reference
drives every device from one process; the port runs one process, a rank, a
device, as PyTorch does. A mesh is `data x model` ranks of one process group,
rank `r = d * model + m` at coordinate (d, m):

- ``data``  — the batch / data-parallel axis: the ranks that share `m` form
  this rank's data group; the dense towers sum their gradients there, and the
  sharded exchange gathers ids and gradients there;
- ``model`` — the second table axis: the ranks that share `d` hold the same
  batch slice and form this rank's model group.

Tables row-shard over the flat rank index, the reference's `FLAT_AXES`
order, so every row exists once globally. Every rank must call `make_mesh`
(the groups are created collectively, in one order); a rank beyond
`data * model` takes part and gets None.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a `data x model` mesh: its flat index `rank`
    (`d * model + m`), its device and its three groups: `group` (every rank
    of the mesh), `data_group` (the ranks that share `m`) and `model_group`
    (the ranks that share `d`; None when `model == 1`)."""

    data: int
    model: int
    rank: int
    device: torch.device
    group: Any
    data_group: Any
    model_group: Any | None
    backend: str

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def d(self) -> int:
        return self.rank // self.model



def _group(ranks: list[int], world: int):
    """The process group of `ranks`: the default group when they are all of
    them (created by every rank either way)."""
    if ranks == list(range(world)):
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(data: int | None = None, model: int = 1,
              device: torch.device | str | None = None) -> Mesh | None:
    """A (data, model) mesh over the first `data * model` ranks of the
    initialized default group (`launch.initialize_distributed`); `data=None`
    takes all the ranks there are. `device` defaults to the group's: the
    current CUDA device under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized first "
                           "(parallel.launch.initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    n = data * model
    if n > world:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks, have {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    group = _group(list(range(n)), world)
    data_groups = [_group([d * model + m for d in range(data)], world) for m in range(model)]
    model_groups = ([_group([d * model + m for m in range(model)], world) for d in range(data)]
                    if model > 1 else None)
    if rank >= n:
        return None
    d, m = divmod(rank, model)
    return Mesh(data=data, model=model, rank=rank, device=torch.device(device), group=group,
                data_group=data_groups[m],
                model_group=None if model_groups is None else model_groups[d],
                backend=backend)


@dataclasses.dataclass(frozen=True)
class Topology:
    num_devices: int
    num_hosts: int
    devices_per_host: int
    platform: str
    device_kind: str
    hbm_bytes_per_device: int | None


def topology_summary(device: torch.device | str | None = None) -> Topology:
    """The topology from the process group and the device: ranks (one a
    device), hosts (torchrun's `LOCAL_WORLD_SIZE` ranks a host), the
    platform ("gpu" or "cpu"), the card's name and its memory."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world)) or 1
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    cuda = device.type == "cuda"
    return Topology(
        num_devices=world,
        num_hosts=max(world // per_host, 1),
        devices_per_host=per_host,
        platform="gpu" if cuda else device.type,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        hbm_bytes_per_device=torch.cuda.mem_get_info(device)[1] if cuda else None,
    )
