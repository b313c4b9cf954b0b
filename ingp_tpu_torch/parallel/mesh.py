"""The data-parallel world (counterpart of the 1-D ('data',) mesh,
ingp_tpu/parallel/mesh.py:29-59): a ray batch split over n ranks,
parameters and grid replicated, gradients averaged.

A `World` of size n is either one rank of a torch.distributed group
(`world_from_group`: this process runs rank r's shard on
cuda:(r % cards)) or all n ranks in one process (`make_mesh(n)`, the
counterpart of JAX's mesh over n virtual devices: the shards run one
after the other and the collectives reduce over them in memory). The
collectives take one value per rank this process runs (`world.ranks`)
and give every rank the same result; a tree is flattened into a few
buckets by dtype, so a step issues a few collectives, not one per leaf.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .distributed import rank_device

BUCKET_ELEMENTS = 1 << 26       # 256 MB of f32 a collective at most


@dataclasses.dataclass(frozen=True)
class World:
    """size: ranks in all; ranks: the ranks this process runs (one in a
    process group, all of them in `make_mesh`); device: where they run;
    group: the torch.distributed group, or None in one process; backend:
    its backend; feeds_own_batch: whether each rank feeds a batch of its
    own (--distributed: the global batch is n x batch_size) rather than
    its slice of one global batch (--num_gpus)."""
    size: int
    ranks: tuple
    device: torch.device
    group: object = None
    backend: str | None = None
    feeds_own_batch: bool = False

    @property
    def rank(self) -> int:
        return self.ranks[0]

    @property
    def is_main(self) -> bool:
        return 0 in self.ranks


def make_mesh(n: int, device="cpu") -> World:
    """n ranks in this process."""
    return World(size=n, ranks=tuple(range(n)),
                 device=torch.device(device))


def world_from_group(device=None, feeds_own_batch=False) -> World:
    """This process's rank of the joined default group, on its card
    (`distributed.rank_device`) or the CPU."""
    rank, size = dist.get_rank(), dist.get_world_size()
    return World(size=size, ranks=(rank,), device=rank_device(rank, device),
                 group=dist.group.WORLD, backend=dist.get_backend(),
                 feeds_own_batch=feeds_own_batch)


def shard_batch(world: World, batch: dict, rank: int) -> dict:
    """Rank `rank`'s rows [r B/n, (r+1) B/n) of every value of a batch of
    B rows; B % n must be 0."""
    n = world.size
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch values of different lengths {sizes}")
    (b,) = sizes
    if b % n:
        raise ValueError(f"a batch of {b} rays does not split over {n} "
                         f"ranks")
    m = b // n
    return {k: v[rank * m:(rank + 1) * m] for k, v in batch.items()}


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _buckets(leaves):
    """[(dtype, [leaf indices])] of at most BUCKET_ELEMENTS elements each
    (a larger leaf alone)."""
    out, open_ = [], {}
    for i, t in enumerate(leaves):
        key = (t.dtype, t.device)
        cur = open_.get(key)
        if cur is None or (cur[1] + t.numel() > BUCKET_ELEMENTS and cur[2]):
            cur = open_[key] = [key, 0, []]
            out.append(cur)
        cur[1] += t.numel()
        cur[2].append(i)
    return [(key, idx) for key, _, idx in out]


def _reduce(world: World, trees, op):
    """Elementwise sum (op "sum") or maximum ("max") of one tree per
    local rank, then over the group."""
    if len(trees) != len(world.ranks):
        raise ValueError(f"{len(trees)} values for the {len(world.ranks)} "
                         f"local ranks")
    per = [_leaves(t, []) for t in trees]
    leaves = [torch.as_tensor(t) for t in per[0]]
    out = [None] * len(leaves)
    for _, idx in _buckets(leaves):
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        for other in per[1:]:
            part = torch.cat([torch.as_tensor(other[i]).reshape(-1)
                              for i in idx])
            flat = flat + part if op == "sum" else torch.maximum(flat, part)
        if world.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX, group=world.group)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    return _rebuild(trees[0], iter(out))


def all_reduce_mean(world: World, trees):
    """The mean over every rank of a tree (one per local rank; float
    leaves), the same on every rank."""
    total = _reduce(world, trees, "sum")
    return _rebuild(total, iter([t / world.size
                                 for t in _leaves(total, [])]))


def all_reduce_max(world: World, trees):
    """The elementwise maximum over every rank of a tree (one per local
    rank)."""
    return _reduce(world, trees, "max")


def gather_rows(world: World, parts):
    """Every rank's rows (one tensor per local rank, all of one shape)
    concatenated in rank order along dim 0, on every rank. Over gloo the
    rows go through the host (gloo has no CUDA all-gather)."""
    local = torch.cat(list(parts)) if len(parts) > 1 else parts[0]
    if world.group is None:
        return local
    via_host = world.backend == "gloo" and local.device.type == "cuda"
    src = local.cpu() if via_host else local.contiguous()
    out = [torch.empty_like(src) for _ in range(world.size)]
    dist.all_gather(out, src, group=world.group)
    return torch.cat(out).to(local.device)


def broadcast_tree(world: World, tree):
    """Rank 0's tree on every rank (a no-op in one process), in place."""
    if world.group is None:
        return tree
    for t in _leaves(tree, []):
        dist.broadcast(t, src=0, group=world.group)
    return tree


def barrier(world: World) -> None:
    if world.group is not None:
        dist.barrier(group=world.group)
