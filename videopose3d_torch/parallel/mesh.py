"""Data parallelism over processes: the port's counterpart of
``videopose3d_tpu/parallel/mesh.py``.

One process per card (``python -m torch.distributed.run``), every process holding
the whole model, the optimizer state and the flat training dataset; each takes
its contiguous rows of every global batch.  What XLA inserts under the JAX
package's mesh is explicit here:

* BatchNorm statistics are global: the per-channel sums go through
  :func:`all_reduce_sum` (plain blocks) or :func:`all_reduce_` between the train
  block's kernel launches, and are divided by the global row count, so a
  data-parallel run equals the single-process run at the same global batch;
* after ``backward``, :func:`all_reduce_gradients` sums the gradients in one flat
  bucket (each rank's loss is its rows' share of the global loss);
* dropout masks are drawn at the global shape from one generator that every rank
  seeds alike, and each rank keeps its rows.

Only ``all_reduce`` and ``broadcast`` are used: gloo supports no other collective
on CUDA tensors.  The training path runs through ``forward_strided``, not
``model.forward``, so ``DistributedDataParallel``'s forward-bound reducer does not
apply.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist


def launcher_world_size() -> int:
    """``WORLD_SIZE`` of the launcher that started this process, 0 without one."""
    return int(os.environ.get("WORLD_SIZE", "0") or 0)


def initialize_distributed(device: torch.device) -> bool:
    """Join the default process group from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, as
    ``python -m torch.distributed.run`` sets them): NCCL for a CUDA ``device``,
    gloo for the CPU.  A default group the caller has initialised already is used
    as it is.

    Returns True when the process is in a process group (at any world size),
    False without a launcher."""
    if dist.is_initialized():
        return True
    if not launcher_world_size():
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", device_id=device)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def process_info() -> dict:
    """This process's place among the ranks."""
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "local_rank": int(os.environ.get("LOCAL_RANK", "0"))}


def shard_batch_size(batch_size: int, world_size: int) -> int:
    """``batch_size`` rounded up to a multiple of ``world_size``."""
    return -(-batch_size // world_size) * world_size


def rank_rows(total: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous rows ``[start, stop)`` of a global batch of
    ``total`` rows: the first ``total % world_size`` ranks take one row more."""
    base, extra = divmod(total, world_size)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place among the ranks that train one model: ``rank`` of
    ``world_size`` over ``group`` (None: the default process group)."""

    rank: int
    world_size: int
    group: object = None

    @classmethod
    def from_group(cls, group=None) -> "DataParallel":
        return cls(dist.get_rank(group), dist.get_world_size(group), group)

    def rows(self, total: int) -> Tuple[int, int]:
        return rank_rows(total, self.rank, self.world_size)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The rows a rank holds of a global batch of ``total`` rows: the
    concatenation of ``segments``, ``(start, stop)`` ranges of the global batch
    (one for a supervised batch; a labeled and an unlabeled one for the
    semi-supervised ``[labeled; unlabeled]`` batch).  BatchNorm sums are
    all-reduced over ``group``."""

    segments: Tuple[Tuple[int, int], ...]
    total: int
    group: object = None

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (a view for one segment)."""
        if len(self.segments) == 1:
            (a, b), = self.segments
            return t[a:b]
        return torch.cat([t[a:b] for a, b in self.segments])


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place; no gradient."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks forward; SUM of the upstream gradients backward (each
    rank's loss is its share of one global loss, so a value every rank uses
    collects the gradient of every rank's share)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM of ``t`` over the ranks of ``group``."""
    return _AllReduceSum.apply(t, group)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Sum the gradients of ``params`` over the ranks, in one flat bucket."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_module(module: Optional[torch.nn.Module], group=None) -> None:
    """Overwrite ``module``'s parameters and buffers with rank 0's."""
    if module is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=group)
