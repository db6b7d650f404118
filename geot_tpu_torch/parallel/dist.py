"""Data parallelism: one process per rank, joined by ``torch.distributed``
(the data-parallel part of ``geot_tpu/parallel/mesh.py``).

``geot_tpu`` runs one jitted step over a dp mesh: the batch axis is sharded,
and the gradient all-reduce and BatchNorm's global batch statistics (which
is SyncBN) fall out of GSPMD. Here every rank runs the step on its block of
each global batch (``data/build.py``'s ``num_shards``/``shard_index``) and
the few collectives the step needs are explicit:

- ``gather`` puts the ranks' blocks of a tensor back into the global batch,
  in rank order, on every rank: the losses, the NTM estimate, the pseudo
  label statistics and the random draws then see the global batch, as in
  ``geot_tpu``. Its backward hands each rank the gradient of its own block;
- ``replicated`` marks a tensor that every rank holds whole (a parameter
  read by the loss); its backward divides the gradient by the world size,
  so that the sum of the ranks' gradients is the global one;
- ``all_reduce_sum`` is BatchNorm's reduction of count, sum and sum of
  squares, with an all-reduce backward;
- ``sum_gradients`` / ``average_gradients`` / ``broadcast_`` after the
  backward.

Only ``all_reduce`` and ``broadcast`` are used: gloo runs no other
collective on CUDA tensors, and two ranks on one card go through gloo
(NCCL refuses two ranks on one device). ``barrier`` is an all-reduce.

``init`` starts the process group from the launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, set by ``engine.launch``) or from
``cfg.jax_distributed`` (``{coordinator_address, num_processes,
process_id}``, as ``geot_tpu``'s configs and tests write it). Without
either, a run is one process on one device.
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as tdist


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return tdist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, the one that writes scalars, logs and checkpoints."""
    return rank() == 0


def backend() -> Optional[str]:
    """The process group's backend (``nccl``, ``gloo``), or None."""
    return str(tdist.get_backend()) if is_initialized() else None


def local_rank() -> int:
    """This process's index among the ranks of its node."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def _rendezvous(cfg) -> Optional[dict]:
    """``{addr, world, rank}`` of the launcher's environment or of
    ``cfg.jax_distributed``, or None for a single process."""
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return {"addr": f"{os.environ['MASTER_ADDR']}:"
                        f"{os.environ['MASTER_PORT']}",
                "world": int(os.environ["WORLD_SIZE"]),
                "rank": int(os.environ["RANK"])}
    jd = (cfg or {}).get("jax_distributed")
    if isinstance(jd, dict) and jd:
        return {"addr": str(jd["coordinator_address"]),
                "world": int(jd["num_processes"]),
                "rank": int(jd["process_id"])}
    if jd:
        raise ValueError(f"jax_distributed={jd!r}: give the rendezvous as "
                         f"{{coordinator_address, num_processes, "
                         f"process_id}} or start the ranks with "
                         f"engine.launch")
    return None


def rank_device(device: "str | torch.device") -> torch.device:
    """The device of this rank: ``cuda:<local_rank>`` when the node has a
    card per rank, else ``cuda:0`` (ranks then share it over gloo); a CPU
    device stays as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or world() == 1:
        return device
    lr = local_rank()
    return torch.device("cuda", lr if lr < torch.cuda.device_count() else 0)


def init(cfg=None, device: "str | torch.device" = "cuda") -> bool:
    """Start the process group if the environment or ``cfg`` names one;
    returns whether this process is one rank of several. The backend is
    NCCL when every local rank has a card of its own, else gloo (the CPU,
    or ranks sharing a card)."""
    if is_initialized():
        return world() > 1
    rv = _rendezvous(cfg)
    if rv is None or rv["world"] == 1:
        return False
    device = torch.device(device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", rv["world"]))
    backend = ("nccl" if device.type == "cuda"
               and local_world <= torch.cuda.device_count() else "gloo")
    if device.type == "cuda":
        lr = int(os.environ.get("LOCAL_RANK", rv["rank"]))
        torch.cuda.set_device(lr if lr < torch.cuda.device_count() else 0)
    tdist.init_process_group(backend, init_method=f"tcp://{rv['addr']}",
                             world_size=rv["world"], rank=rv["rank"],
                             timeout=datetime.timedelta(minutes=10))
    return True


def shutdown() -> None:
    if is_initialized():
        tdist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (an all-reduce of one element, on the card under
    NCCL)."""
    if world() > 1:
        device = ("cuda" if tdist.get_backend() == "nccl" else "cpu")
        tdist.all_reduce(torch.zeros(1, device=device))


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` takes rank ``src``'s value on every rank, in place."""
    if world() > 1:
        tdist.broadcast(t, src)
    return t


def broadcast_object(obj, device: "str | torch.device" = "cpu"):
    """Rank 0's value of a small int or float, on every rank."""
    if world() == 1:
        return obj
    t = torch.tensor([float(obj)], dtype=torch.float64, device=device)
    tdist.broadcast(t, 0)
    return type(obj)(t.item())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; the gradient of a
    rank's ``x`` is the sum of the ranks' gradients of the result."""
    return _AllReduceSum.apply(x) if world() > 1 else x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n, r = x.shape[0], rank()
        ctx.block = (r * n, (r + 1) * n)
        buf = x.new_zeros((world() * n, *x.shape[1:]))
        buf[r * n:(r + 1) * n] = x
        tdist.all_reduce(buf)       # adding zeros is exact
        return buf

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.block
        return g[lo:hi]


def gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of ``x`` (equal first axes) stacked in rank order
    along the first axis, on every rank. Every rank must compute the same
    function of the result: the gradient that reaches a rank's ``x`` is
    the result's gradient on its own block."""
    return _Gather.apply(x) if world() > 1 else x


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / world()


def replicated(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``x``, held whole and equal by every rank, with its gradient divided
    by the world size: every rank computes the full gradient of the
    global loss through it, and the ranks' gradients are summed."""
    if x is None or world() == 1:
        return x
    return _Replicated.apply(x)


def sum_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's gradient summed over the ranks, in one flat
    all-reduce (every gradient must exist)."""
    if world() == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's gradient averaged over the ranks: for a module
    whose full gradient every rank computed, so that the ranks hold the
    same bits."""
    params = list(params)
    if world() == 1:
        return
    sum_gradients(params)
    for p in params:
        p.grad.div_(world())


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (no gradient)."""
    if world() > 1:
        tdist.all_reduce(t)
    return t


def assert_same(tensors: Iterable[torch.Tensor], what: str) -> None:
    """Raise on every rank unless every rank holds the same ``tensors``:
    each tensor's float64 sum and sum of squares, compared bit for bit
    with rank 0's."""
    if world() == 1:
        return
    local = torch.stack([torch.stack([t.double().sum(),
                                      t.double().square().sum()])
                         for t in tensors]).reshape(-1)
    ref = broadcast_(local.clone())
    bad = torch.tensor([0.0 if torch.equal(ref.view(torch.int64),
                                           local.view(torch.int64))
                        else 1.0], dtype=torch.float64, device=local.device)
    all_reduce_sum_(bad)
    if bad.item():
        raise RuntimeError(f"the ranks hold different {what}")
