"""Data parallelism: one process per rank, joined by ``torch.distributed``
(the data-parallel part of ``geot_tpu/parallel/mesh.py``).

``geot_tpu`` runs one jitted step over a dp mesh: the batch axis is sharded,
and the gradient all-reduce and BatchNorm's global batch statistics (which
is SyncBN) fall out of GSPMD. Here every rank runs the step on its block of
each global batch (``data/build.py``'s ``num_shards``/``shard_index``) and
the few collectives the step needs are explicit.

Every rank computes the same global loss, and back-propagates its share,
``loss / world`` (``backward_share``): a rank's gradient is its part of the
global one, and the parts add up to it. The collectives' backward follows
that convention in both orders of differentiation:

- ``gather`` puts the ranks' blocks of a tensor back into the global batch,
  in rank order, on every rank: the losses, the NTM estimate, the pseudo
  label statistics and the random draws then see the global batch, as in
  ``geot_tpu``. Its backward hands each rank the sum of the ranks'
  gradients of its block: in a first backward, where every rank holds the
  same gradient of the global tensor (the same loss of it), that sum is
  ``world`` times its own, and no collective runs; under ``create_graph``
  it is an all-reduce;
- ``all_reduce_sum`` is BatchNorm's reduction of count, sum and sum of
  squares, with an all-reduce backward;
- ``sum_gradients`` and ``broadcast_`` after the backward.

Each backward is itself made of these differentiable collectives, so a
second backward through the first one's graph (AdaHessian's
``create_graph=True`` pass, ``optim.adahessian``) sends every rank's part
of ``H z`` where it belongs: a rank's gradient of ``g . z`` with respect to
another rank's rows reaches that rank through the gather's backward.

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
import socket
from typing import Iterable, Optional, Tuple

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


def get_dist_info() -> Tuple[int, int]:
    """``(rank, world size)`` (``geot_tpu/parallel/mesh.py:172``)."""
    return rank(), world()


def find_free_port() -> int:
    """A TCP port on localhost that was free a moment ago
    (``geot_tpu/parallel/mesh.py:182``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


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
        # the ranks' parts of the gradient, summed; differentiable, for a
        # second backward
        return _AllReduceSum.apply(g)


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
        if not torch.is_grad_enabled():
            # a first backward: the ranks' gradients of the global tensor
            # are equal, so their sum is this rank's times the world
            return g[lo:hi] * world()
        # for a second backward, whose gradients of the result differ
        # over the ranks: the sum itself, differentiable
        return _AllReduceSum.apply(g)[lo:hi]


def gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks of ``x`` (equal first axes) stacked in rank order
    along the first axis, on every rank. Every rank must compute the same
    function of the result. The gradient that reaches a rank's ``x`` is
    the sum over the ranks of their gradients of the result on its
    block."""
    return _Gather.apply(x) if world() > 1 else x


def backward_share(loss: torch.Tensor) -> torch.Tensor:
    """The share of the global ``loss`` (equal on every rank) that this
    rank back-propagates: ``loss / world``."""
    return loss / world() if world() > 1 else loss


def sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor summed over the ranks, in place, in one flat
    all-reduce."""
    if world() == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def sum_gradients(params: Iterable[torch.Tensor]) -> None:
    """Each parameter's gradient summed over the ranks, in one flat
    all-reduce (every gradient must exist)."""
    sum_(p.grad for p in params)


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
