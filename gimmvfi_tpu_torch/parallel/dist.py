"""Data parallelism: one process a card (`gimmvfi_tpu/parallel/mesh.py`),
and the collectives of spatial sharding (`spatial.py`).

The JAX package trains over a 1-D `data` mesh: parameters replicated, the
global batch sharded on its first axis, one process a host that loads the
host's share (`data/loader.py: shard_id / num_shards`) and cuts it into
contiguous rows, one block a device (`shard_batch`); XLA inserts the
gradient's reduction and flax's BatchNorm takes the statistics of the
whole sharded batch. The port runs one process a card, launched by
`torchrun` (`python -m torch.distributed.run`), with the same mapping: a
torchrun node is a JAX host and a local rank one of its devices. So host
`h` of `H` loads `order[h::H]` in host batches of `B x local_world`, and
local rank `l` takes rows `[l B, (l + 1) B)` of each.

The collectives are explicit here:
  * `all_reduce_sum`: a summing all-reduce whose backward all-reduces the
    gradient (BatchNorm's cross-rank statistics, `nn/layers.py`);
  * `average_gradients_`: every gradient's mean over the ranks, in one
    flat all-reduce, before the clip and the optimizer step;
  * `global_mean`: a dict of metrics averaged over the ranks (every loss
    is a mean over equal per-rank batches, so this is the global batch's);
  * `broadcast_module_`: rank 0's parameters and buffers on every rank
    (the mesh's `replicate`);
  * `gather_disjoint`: a whole tensor on every rank from each rank's
    disjoint piece of one axis, by a summing all-reduce;
  * `exchange_halo`: each rank's piece of one axis widened by the
    columns next to it that other ranks hold, by one summing all-reduce of
    the edge columns alone.

With no process group every helper returns its input or does nothing, so
one process computes exactly what it did before data parallelism.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclass(frozen=True)
class Topology:
    """Where this process sits: its global and local rank, and its device."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")

    @property
    def host(self) -> int:
        """The node (a JAX host) this process runs on."""
        return self.rank // self.local_world

    @property
    def hosts(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def launched() -> bool:
    """Whether a launcher (`torchrun`) set this process's rank and world."""
    return "WORLD_SIZE" in os.environ


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the running group; 1 without one."""
    return dist.get_world_size() if group_up() else 1


def rank() -> int:
    return dist.get_rank() if group_up() else 0


def init(device, backend: str | None = None, *, rank: int | None = None,
         world: int | None = None, local_rank: int | None = None,
         local_world: int | None = None, init_method: str = "env://") -> Topology:
    """Start the process group and return this process's `Topology`.

    The ranks come from the arguments, else from torchrun's environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`; `GROUP_RANK`
    must be the node `RANK // LOCAL_WORLD_SIZE`). `device` "cuda" means
    `cuda:<local rank>`; a device with an index is taken as it is (two gloo
    ranks on one card). The backend defaults to NCCL on CUDA and gloo on
    the CPU. A failed start raises."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world = int(env["WORLD_SIZE"]) if world is None else world
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world = int(env.get("LOCAL_WORLD_SIZE", world)) if local_world is None else local_world
    if world % local_world or not (0 <= local_rank < local_world and 0 <= rank < world):
        raise ValueError(f"rank {rank} of {world}, local rank {local_rank} of {local_world}: "
                         f"not one of equal nodes")
    if "GROUP_RANK" in env and int(env["GROUP_RANK"]) != rank // local_world:
        raise ValueError(f"GROUP_RANK {env['GROUP_RANK']} is not RANK // LOCAL_WORLD_SIZE "
                         f"= {rank // local_world}: ranks must be contiguous by node")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)
    return Topology(rank, world, local_rank, local_world, device)


def shutdown():
    """End the process group, if one is up."""
    if group_up():
        dist.destroy_process_group()


def barrier():
    if not group_up():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (picklable objects)."""
    if not group_up():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank. Each rank's loss
    depends on every rank's x through y, so the gradient of x is the sum
    over the ranks of dL_r / dy: backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of `x` over the ranks; `x` itself without a group."""
    return _AllReduceSum.apply(x) if group_up() else x


@torch.no_grad()
def average_gradients_(params) -> None:
    """Replace each parameter's `.grad` by its mean over the ranks, in one
    flat all-reduce. A rank whose parameter has no gradient adds zeros; a
    parameter with no gradient on any rank keeps `None`, as one process
    would (the optimizer then skips it). The host waits for the device
    only on a rank that lacks a gradient. Does nothing without a group."""
    if not group_up():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    missing = [p.grad is None for p in params]
    ref = params[0]
    # per parameter, the ranks that hold its gradient
    held = (torch.tensor([not m for m in missing], dtype=ref.dtype).to(ref.device) if any(missing)
            else torch.ones(len(params), dtype=ref.dtype, device=ref.device))
    flat = torch.cat([(torch.zeros_like(p) if m else p.grad).reshape(-1)
                      for p, m in zip(params, missing)] + [held])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    held = flat[-len(params):].tolist() if any(missing) else [1.0] * len(params)
    offset = 0
    for p, m, h in zip(params, missing, held):
        n = p.numel()
        mean = flat[offset:offset + n].view_as(p)
        if not m:
            p.grad.copy_(mean)
        elif h > 0:
            p.grad = mean.clone()
        offset += n


@torch.no_grad()
def global_mean(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each 0-d tensor of `metrics` averaged over the ranks (one all-reduce);
    `metrics` itself without a group."""
    if not group_up() or not metrics:
        return metrics
    stacked = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return dict(zip(metrics, stacked.unbind()))


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, group=None) -> None:
    """Set every parameter and buffer of `module` to those of rank 0 of
    `group` (the default group if None), one flat broadcast a dtype: the
    JAX mesh's `replicate`, so ranks that built their model differently
    compute with one set of weights. Does nothing without a group."""
    if not group_up():
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src, group=group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def gather_disjoint(part: torch.Tensor, lo: int, hi: int, size: int, dim: int,
                    group=None) -> torch.Tensor:
    """The whole tensor, `size` long on `dim`, on every rank of `group`,
    from each rank's piece `part`, its indices [lo, hi) on that axis: a
    zero-filled whole buffer that each rank fills in its piece, then a
    summing all-reduce. The pieces are disjoint, so every element is one
    rank's value plus zeros and the sum is exact; the pieces may be
    uneven, and gloo takes CUDA tensors this way. 16-bit pieces are summed
    in float32 (exact all the same). Without a group, the buffer (`part`
    must then cover the axis)."""
    shape = list(part.shape)
    shape[dim] = size
    wide = part.dtype in (torch.float16, torch.bfloat16) and group_up()
    out = part.new_zeros(shape, dtype=torch.float32 if wide else part.dtype)
    out.narrow(dim, lo, hi - lo).copy_(part)
    if group_up():
        dist.all_reduce(out, group=group)
    return out.to(part.dtype)


def exchange_halo(part: torch.Tensor, strips: list[tuple[int, int]], halo: int, dim: int,
                  group=None) -> torch.Tensor:
    """This rank's piece `part`, indices strips[rank] = [lo, hi) of an axis
    `strips[-1][1]` long that the ranks' `strips` tile in rank order,
    widened to [max(0, lo - halo), min(size, hi + halo)) on every rank of
    `group`: what slicing the whole tensor there gives. A buffer of 2
    `halo`-wide slots a rank (the columns left of its strip, then right of
    it), zero-filled; each rank fills the columns of every other rank's
    slots that lie in its own piece, then one summing all-reduce. A slot
    may span several ranks' pieces (a halo wider than a strip); columns
    past either end of the axis are not returned. 16-bit tensors are summed
    in float32: every element is one rank's value plus zeros, so the result
    is exact. Without a group, `part` (which must then be the whole axis)."""
    if not group_up():
        return part
    rank = dist.get_rank(group)
    lo, hi = strips[rank]
    size = strips[-1][1]
    if part.shape[dim] != hi - lo:
        raise ValueError(f"rank {rank}'s piece is {part.shape[dim]} long on dim {dim}, its strip "
                         f"{(lo, hi)}")
    if halo == 0:
        return part
    work = part if part.dtype in (torch.float32, torch.float64) else part.float()
    shape = list(work.shape)
    shape[dim] = halo
    buf = work.new_zeros([len(strips), 2] + shape)
    for d, (a, b) in enumerate(strips):
        if d == rank:
            continue
        for side, start in enumerate((a - halo, b)):
            o0, o1 = max(start, lo), min(start + halo, hi)
            if o0 < o1:
                buf[d, side].narrow(dim, o0 - start, o1 - o0).copy_(
                    work.narrow(dim, o0 - lo, o1 - o0))
    dist.all_reduce(buf, group=group)
    left, right = lo - max(0, lo - halo), min(size, hi + halo) - hi
    edges = buf[rank, 0].narrow(dim, halo - left, left), buf[rank, 1].narrow(dim, 0, right)
    return torch.cat([edges[0].to(part.dtype), part, edges[1].to(part.dtype)], dim=dim)


def _rank_main(local_rank, fn, args, world, device, backend, init_method):
    init(device, backend, rank=local_rank, world=world, local_rank=local_rank,
         local_world=world, init_method=init_method)
    try:
        fn(*args)
    finally:
        shutdown()


def spawn_ranks(fn, world: int, args=(), *, device="cpu", backend: str | None = None,
                rendezvous: str) -> None:
    """Run `fn(*args)` on `world` ranks of this machine, each a spawned
    process with the group started (`init`) and ended around the call;
    `rendezvous` is a file path that must not exist yet (the group's file
    store). `fn` must be importable; results travel through files. Raises
    if any rank fails."""
    if os.path.exists(rendezvous):
        raise FileExistsError(f"the rendezvous file {rendezvous} exists")
    mp.start_processes(_rank_main, args=(fn, args, world, str(device), backend,
                                         f"file://{os.path.abspath(rendezvous)}"),
                       nprocs=world, join=True, start_method="spawn")
