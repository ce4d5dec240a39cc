"""Process-group helpers: port of ``slak_tpu/parallel/mesh.py``.

The JAX package expresses data parallel as a 1-D device mesh over the
``data`` axis inside one program; the port runs one process a rank, as the
reference does (DDP + NCCL, ``utils.py:252-332``, ``main.py:374-376``).
The mesh becomes a ``torch.distributed`` process group:

  * :func:`init_distributed` joins it (a launcher's ``env://`` variables,
    or an explicit ``init_method`` / rank / world size), with this rank's
    device ``cuda:<local_rank>`` and a timeout, so that a broken
    rendezvous or a lost rank fails instead of hanging;
  * :func:`rank` and :func:`world` (0 and 1 outside a group);
  * :func:`shard_batch`: the rank's contiguous slice of a global batch;
  * :func:`replicate`: a broadcast of tensors (a module's parameters and
    buffers) from rank 0;
  * :func:`all_reduce_` : the coalesced in-place sum or mean of a list of
    tensors (the gradient all-reduce, the eval sums);
  * :func:`axis_group`: the group of a mesh axis name (:data:`DATA_AXIS`,
    the whole world), which ``SLaKConfig.bn_axis_name`` names for SyncBN,
    as the JAX config names a mesh axis.

As in the JAX module, no mask broadcast is needed (reference
``sparse_core.py:404-407``): mask updates are deterministic functions of
replicated weights, all-reduced gradients and a generator seeded the same
on every rank, so every rank computes the same masks.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 1800.0
# elements a bucket of the coalesced all-reduce (64 MiB of float32)
BUCKET_ELEMS = 1 << 24


def env_rank_world():
    """(rank, world size, local rank) from a launcher's environment
    (``torchrun``, or ``--multi_host`` with RANK / WORLD_SIZE set), or
    None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    r = int(os.environ["RANK"])
    return r, int(os.environ["WORLD_SIZE"]), int(os.environ.get(
        "LOCAL_RANK", r))


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device of the rank with ``local_rank``: ``device`` when it is
    given (``"cpu"``, or a CUDA device type with or without an index),
    else CUDA; a CUDA device without an index becomes
    ``cuda:<local_rank mod card count>`` (several ranks share a card when
    there are fewer cards than ranks)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(backend: str = "nccl", init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    Rank, world size and local rank come from the arguments, else from the
    environment (:func:`env_rank_world`). ``backend`` is ``"nccl"`` (one
    card a rank) or ``"gloo"`` (CPU tensors, or several ranks sharing a
    card: gloo stages CUDA tensors through host memory); NCCL with more
    local ranks than cards raises, since NCCL refuses two ranks of one
    communicator on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {'/'.join(BACKENDS)}")
    env = env_rank_world()
    if rank is None or world_size is None:
        if env is None:
            raise RuntimeError(
                "init_distributed: no rank / world size given and none in "
                "the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,"
                " MASTER_PORT, as torchrun sets them)")
        rank, world_size = env[0], env[1]
        local_rank = env[2] if local_rank is None else local_rank
    local_rank = rank if local_rank is None else local_rank
    dev = rank_device(local_rank, device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices; pass "
                             "--dist_backend gloo for CPU ranks")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_world > torch.cuda.device_count():
            raise ValueError(
                f"nccl: {local_world} local ranks on "
                f"{torch.cuda.device_count()} card(s); NCCL takes one card a "
                f"rank (pass --dist_backend gloo to share a card)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def destroy():
    """Leave the process group (no-op outside one)."""
    if initialized():
        dist.destroy_process_group()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def barrier():
    """Wait for every rank (no-op outside a group)."""
    if world() > 1:
        dist.barrier()


def axis_group(name: str = DATA_AXIS) -> dist.ProcessGroup:
    """The process group of mesh axis ``name``: the world, once
    :func:`init_distributed` has joined it."""
    if name != DATA_AXIS or not initialized():
        raise RuntimeError(
            f"no process group for axis {name!r}: the axis is "
            f"{DATA_AXIS!r}, joined by init_distributed")
    return dist.group.WORLD


def shard_batch(batch, index: Optional[int] = None,
                count: Optional[int] = None):
    """This rank's slice along dim 0 of ``batch``, a tensor or a tuple /
    list of them: rows ``[index * n, (index + 1) * n)`` with
    ``n = len / count``."""
    index = rank() if index is None else index
    count = world() if count is None else count
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % count:
            raise ValueError(f"batch of {batch.shape[0]} does not split "
                             f"into {count} shards")
        n = batch.shape[0] // count
        return batch[index * n:(index + 1) * n]
    return type(batch)(shard_batch(v, index, count) for v in batch)


@torch.no_grad()
def replicate(tensors, src: int = 0, group=None):
    """Broadcast ``tensors`` (an iterable of tensors, or a module: its
    parameters and buffers) in place from rank ``src``."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    if not initialized():
        return
    for t in tensors:
        dist.broadcast(t.data, src, group=group)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and device, at most
    BUCKET_ELEMS elements a run (a larger tensor alone)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        if run and (size + t.numel() > BUCKET_ELEMS
                    or t.dtype != tensors[run[0]].dtype
                    or t.device != tensors[run[0]].device):
            yield run
            run, size = [], 0
        run.append(i)
        size += t.numel()
    if run:
        yield run


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], op: str = "sum",
                group=None):
    """In place: every tensor summed (``op="sum"``) or averaged
    (``"mean"``) over the group, a few flat buffers at a time rather than
    one call a tensor. Outside a group a no-op; a group of one still runs
    the collective (its sum is the tensor, bit for bit)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op {op!r}: sum or mean")
    if not initialized():
        return
    n = world(group)
    tensors = list(tensors)
    for run in _buckets(tensors):
        ts = [tensors[i] for i in run]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if op == "mean":
            flat /= n
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather_cat(x: torch.Tensor, dim: int = 0,
                   group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if not initialized():
        return x
    n = world(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)
