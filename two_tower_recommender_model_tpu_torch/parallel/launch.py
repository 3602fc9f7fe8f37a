"""Launch: process setup, scaling modes, per-host batch slicing.

Port of `two_tower_recommender_model_tpu/parallel/launch.py`. The reference
runs one process a host and drives its chips from it; PyTorch runs one
process (a rank) a device, started by torchrun:

    python -m torch.distributed.run --nproc-per-node N \\
        -m two_tower_recommender_model_tpu_torch.cli.train ...

    SINGLE_CHIP   1 rank, 1 device
    SINGLE_HOST   N ranks, one a local device
    MULTI_HOST    ranks on several hosts

`initialize_distributed` reads torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL on
`cuda:LOCAL_RANK` unless the caller passes `device="cpu"`, which takes gloo.
There is no silent CPU fallback. A single rank started without torchrun
rendezvouses on a free loopback port.

One host feeds a global batch, as the reference's single process does:
every rank runs the same loader and keeps its data slice of each batch
(`parallel.sharded.batch_sharding`). Across hosts (`--multi-host`, torchrun
with `--nnodes`), each host streams a disjoint slice of the data
(`per_host_loader_slice`) and the global batch is the hosts' batches in
host order: every rank of a host runs the host's loader and keeps its data
slice of the host's batch (`put_global_batch`), with no collective. A host
is torchrun's node (`GROUP_RANK`, `LOCAL_WORLD_SIZE` ranks), not a process:
the reference runs one process a host, the port one a device.
"""

from __future__ import annotations

import datetime
import enum
import logging
import os
import socket

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


class TrainingMethod(str, enum.Enum):
    SINGLE_CHIP = "single_chip"  # SNSG
    SINGLE_HOST = "single_host"  # SNMG
    MULTI_HOST = "multi_host"  # MNMG


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device: torch.device | str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           init_method: str | None = None,
                           timeout_s: float | None = None) -> torch.device:
    """Join the default process group once per process and return this
    rank's device. World size and rank come from the arguments, else from
    torchrun's environment, else 1 and 0. `device=None` is
    `cuda:LOCAL_RANK` under NCCL; `device="cpu"` takes gloo. Without
    `init_method` the rendezvous is `MASTER_ADDR:MASTER_PORT`, or a free
    loopback port for a single rank started without torchrun."""
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device for the NCCL group: pass device="cpu" to run '
                               "the ranks on the CPU over gloo")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        else:
            raise RuntimeError(f"{world} ranks need a rendezvous: set MASTER_ADDR and "
                               "MASTER_PORT (torchrun does) or pass init_method")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)
    log.info("distributed: rank %d/%d on %s (%s)", rank, world, device, backend)
    return device


def initialize_multi_host(coordinator_address: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None,
                          device: torch.device | str | None = None) -> torch.device:
    """`initialize_distributed` with the reference's argument names: the
    coordinator `host:port`, the number of processes (ranks) and this one's
    index, each falling back on torchrun's environment."""
    init_method = f"tcp://{coordinator_address}" if coordinator_address else None
    return initialize_distributed(device, num_processes, process_id, init_method)


def devices_for(method: TrainingMethod) -> list[torch.device]:
    """The devices a method runs on from this host: the first card, or all
    of them (a rank each)."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    n = 1 if method == TrainingMethod.SINGLE_CHIP else torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)]


def host_info() -> dict:
    """This rank's place: its index and the number of ranks, the ranks on
    this host and in all, and the host's index among the hosts (torchrun's
    `GROUP_RANK` and `LOCAL_WORLD_SIZE`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return {"process_index": rank, "process_count": world, "local_devices": local,
            "global_devices": world, "host_index": int(os.environ.get("GROUP_RANK", "0")),
            "num_hosts": max(world // max(local, 1), 1)}


def per_host_loader_slice() -> tuple[int, int]:
    """(host_index, num_hosts) for `StreamLoader`: each host streams a
    disjoint shard subset, and every rank of a host the same one."""
    info = host_info()
    return info["host_index"], info["num_hosts"]


def global_batch_slice(global_batch_size: int) -> int:
    """Per-host batch size for a data-parallel global batch."""
    n = host_info()["num_hosts"]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} hosts")
    return global_batch_size // n


def mesh_hosts(mesh) -> int:
    """The hosts a mesh spans, checked against its layout: the ranks `r = d
    x model + m` of a host hold whole data slices, in host order, only when
    every host has the same number of ranks, a multiple of `model`."""
    info = host_info()
    hosts, local = info["num_hosts"], info["local_devices"]
    if hosts == 1:
        return 1
    if local * hosts != info["process_count"] or mesh.size != info["process_count"]:
        raise ValueError(f"a {mesh.data}x{mesh.model} mesh over {hosts} hosts of {local} "
                         f"ranks needs every rank of the {info['process_count']} in it")
    if local % mesh.model:
        raise ValueError(f"{local} ranks a host do not hold whole data slices of a mesh with "
                         f"model={mesh.model}: pick LOCAL_WORLD_SIZE a multiple of it")
    if info["host_index"] != mesh.rank // local:
        raise ValueError(f"rank {mesh.rank} is on host {info['host_index']}, not on "
                         f"{mesh.rank // local}: the hosts' ranks must be numbered in order")
    return hosts


def put_global_batch(local_batch, mesh):
    """This rank's part of a global batch from its host's local batch: its
    data slice of the host's batch (the hosts' batches in host order make
    the global one), on its device, with no collective. On one host it is
    `device_put_batch` with `batch_sharding`."""
    from two_tower_recommender_model_tpu_torch.parallel.sharded import batch_sharding
    from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch

    return device_put_batch(local_batch, sharding=batch_sharding(mesh, mesh_hosts(mesh)))
