"""Process-group plumbing (counterpart of ingp_tpu/parallel/
distributed.py:14-68): joining a group, the rank-0 gate, and the two
host-side collectives the training loop needs (a broadcast int, a
gathered metric list).

One process is one rank. `init_distributed` joins the group over
tcp://<coordinator_address> (or a full init URL such as file://...), or
over env:// without arguments, as under torchrun. Its backend is NCCL
when every rank of the host has a card of its own and gloo when ranks
share a card or run on the CPU (`backend_for`).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _local_size(size: int) -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else all of them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", size))


def rank_device(rank: int, device=None) -> torch.device:
    """The device of rank `rank`: the CPU when `device` names it, else
    cuda:(local rank % the host's card count)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(size: int, device=None) -> str:
    """"nccl" when the ranks run on cards and each has a card of its own,
    else "gloo" (NCCL refuses two ranks on one card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and _local_size(size) <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None) -> bool:
    """Join the process group (torch.distributed.init_process_group):
    over tcp://coordinator_address (an address with "://" is taken as
    the init URL itself) with num_processes ranks, this one process_id;
    with no address, over env:// (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, as torchrun sets them). A world of one process, or a group
    already joined, is a no-op. Returns whether a group of more than one
    rank is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        size = num_processes or int(os.environ.get("WORLD_SIZE", 1))
        init = "env://"
    else:
        size = num_processes or 1
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    if size <= 1:
        return False
    rank = process_id if process_id is not None else \
        int(os.environ.get("RANK", 0))
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(size, device)
    kw = {} if init == "env://" else {"world_size": size, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kw)
    if dist.get_rank() == 0:
        print(f"[distributed] {size} ranks over {backend} ({init})",
              flush=True)
    return True


def is_main_process() -> bool:
    """The rank-0 gate (True outside a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_int(value):
    """Rank 0's int (or None, sent as -1) on every rank, so that every
    rank takes the same branch (e.g. "resume from step N")."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [-1 if value is None else int(value)]
    dist.broadcast_object_list(box, src=0)
    return None if box[0] < 0 else box[0]


def all_gather_metrics(values):
    """Every rank's list of floats, concatenated in rank order, on every
    rank (as Python objects: gloo has no CUDA all-gather). The lists may
    differ in length."""
    values = [float(v) for v in values]
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return values
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, values)
    return [v for part in out for v in part]
