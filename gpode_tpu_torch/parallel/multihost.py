"""Process groups and rank-to-rank transfers for multi-device training.

Counterpart of `gpode_tpu/parallel/multihost.py` on `torch.distributed`.
One process per card: parameters and optimizer state are replicated (rank
0's values are broadcast once, so every rank starts bit-equal), sequences
split over `dp` and MC samples over `mc`, and a train step exchanges only
its gradient and ELBO-term all-reduce and its solver-statistics all-reduce
(`parallel/train.py`).

Usage, one rank per card (`torchrun` sets the rendezvous environment):

    torchrun --nproc_per_node=2 -m \\
        gpode_tpu_torch.scripts.train_mocap_gpode_shooting --mesh dp=2

or by hand, every process calling

    multihost.initialize("tcp://10.0.0.1:8476", num_processes=2,
                         process_id=rank)

before the drivers build their mesh (`make_mesh`). A plain process that asks
for a mesh without either starts a world of 1 by itself.

Backends: NCCL when the ranks run on CUDA cards and each rank of a host has
a card of its own; gloo on the CPU, and when ranks share a card (NCCL
refuses two ranks on one GPU; gloo reduces a card's tensors there).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gpode_tpu_torch import resolve_device

# every collective and the rendezvous give up after this long, so a rank
# that died fails its peers instead of hanging them
DEFAULT_TIMEOUT_S = 600.0


def local_device(device=None) -> torch.device:
    """The device of this rank: `device` when it names one, else (None or
    an unindexed "cuda") the card `cuda:{LOCAL_RANK % device_count}`;
    raises without a card (entry points never drop to the CPU on their
    own)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def backend_for(device: torch.device, local_world_size: int) -> str:
    """'nccl' when the ranks' device is a card and each of the host's
    `local_world_size` ranks has its own, else 'gloo'."""
    if (device.type == "cuda"
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start or join the default process group; returns False when one was
    already running (this call then does nothing).

    `coordinator_address` ('host:port', or an init-method URL such as
    'tcp://host:port' or 'file:///path') with `num_processes` and
    `process_id` joins that rendezvous; without it the `torchrun`
    environment's (MASTER_ADDR, WORLD_SIZE, RANK) is used, and without that
    a world of 1 starts in this process. `device` is the ranks' device (see
    `local_device`), which picks the backend; the local world size is
    LOCAL_WORLD_SIZE, or the world's for a hand-started group."""
    if dist.is_initialized():
        return False
    dev = local_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw = dict(init_method=url, world_size=num_processes, rank=process_id)
        world = num_processes
    elif "MASTER_ADDR" in os.environ:
        kw = dict(init_method="env://")
        world = int(os.environ["WORLD_SIZE"])
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
        world = 1
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, local_world), timeout=timeout,
                            **kw)
    return True


@torch.no_grad()
def broadcast_params(module: torch.nn.Module, src: int = 0):
    """Overwrite every floating-point parameter and buffer of `module` with
    rank `src`'s (one flat transfer), so the ranks hold bit-equal
    replicas."""
    tensors = [t for t in (*module.parameters(), *module.buffers())
               if t.is_floating_point()]
    # float64 carries float32 and float64 values bit-exactly
    flat = torch.cat([t.reshape(-1).double() for t in tensors])
    dist.broadcast(flat, src)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def global_array(value, mesh=None, axis: Optional[str] = None,
                 device=None) -> torch.Tensor:
    """This rank's part of a host value every rank holds in full: the whole
    value (`axis` None: replicated), or its block of the leading dimension
    over the mesh axis `axis` (sequences over "dp")."""
    t = torch.as_tensor(np.asarray(value), device=device)
    if axis is None:
        return t
    lo, hi = mesh.block(axis, t.shape[0])
    return t[lo:hi].contiguous()


def global_put(tree: dict, mesh=None, axis: Optional[str] = None,
               device=None) -> dict:
    """`global_array` over the values of a dict."""
    return {k: global_array(v, mesh, axis, device) for k, v in tree.items()}


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """Host value of a replicated tensor (every rank holds the same)."""
    return x.detach().cpu().numpy()
