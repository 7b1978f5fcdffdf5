"""Process groups and the few collectives the port's parallel paths use.

Counterpart of the JAX package's ``parallel/mesh.py``. There a mesh of
devices carries named axes and XLA inserts the collectives; here one
process runs per rank under ``torch.distributed`` and the code calls the
collectives itself:

* ``SeqGroup`` holds a process group, this process's rank and the
  group's size in it, the rank's device and the backend;
* ``make_group`` joins the default group through a file store (the JAX
  ``make_mesh``) and ``split_groups`` names this process's subgroup;
* ``psum`` / ``pmax`` (``all_reduce`` SUM / MAX), ``all_gather`` and
  ``neighbour_halos`` (the two ``ppermute`` halo shifts of the JAX code,
  as one ``all_gather`` of the small head and tail halos, which works the
  same on NCCL and gloo, on the CPU and on the card) and
  ``all_gather_grad`` (an ``all_gather`` whose backward sums the
  gradients of every rank's loss);
* ``spawn`` starts the ranks of a group from one process and returns what
  each rank's function returned.

The backend is named, never guessed per collective: ``nccl`` for ranks on
CUDA devices, ``gloo`` for ranks on the CPU (or, named by the caller,
ranks that share one card). gloo's collectives take CPU tensors, so on
the gloo backend a CUDA tensor is staged through host memory for the
collective alone, and the result goes back to the tensor's device; the
compute stays on the rank's device.
"""

from __future__ import annotations

import pickle
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = [
    "SeqGroup",
    "rank_device",
    "make_group",
    "split_groups",
    "psum",
    "pmax",
    "all_gather",
    "all_gather_grad",
    "neighbour_halos",
    "spawn",
]

DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class SeqGroup:
    """One process's view of a process group: ``rank`` and ``size`` are
    within ``group`` (None: the default group)."""

    group: "dist.ProcessGroup | None"
    rank: int
    size: int
    device: torch.device
    backend: str


def rank_device(rank: int, device: "str | torch.device" = "cuda") -> torch.device:
    """The device of global rank ``rank``: ``cuda:(rank % device_count)``
    when ``device`` is "cuda" without an index, else ``device`` itself.
    Sets the float32 policy (``resolve_device``) and, on CUDA, the current
    device."""

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_group(
    rank: int,
    world_size: int,
    store_path: "str | Path",
    *,
    backend: "str | None" = None,
    device: "str | torch.device" = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> SeqGroup:
    """Join the default process group as ``rank`` of ``world_size``
    through a ``FileStore`` at ``store_path`` (no TCP port) and return the
    world's ``SeqGroup``, on ``rank_device(rank, device)``. ``backend``
    defaults to nccl on CUDA and gloo on the CPU."""

    dev = rank_device(rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size, timeout=timedelta(seconds=timeout_s)
    )
    return SeqGroup(None, rank, world_size, dev, dist.get_backend())


def split_groups(world: SeqGroup, partition: "Sequence[Sequence[int]]") -> SeqGroup:
    """This process's group among the disjoint ``partition`` of the world's
    ranks (e.g. the tp groups [[0, 1], [2, 3]]), on the world's device and
    backend. Every process creates every group, in the same order, as
    ``torch.distributed.new_group`` requires."""

    mine = None
    for ranks in partition:
        ranks = [int(r) for r in ranks]
        group = dist.new_group(ranks, backend=world.backend)
        if world.rank in ranks:
            mine = SeqGroup(group, ranks.index(world.rank), len(ranks), world.device, world.backend)
    if mine is None:
        raise ValueError(f"rank {world.rank} is in none of the groups {partition}")
    return mine


# ---------------------------------------------------------------------------
# Collectives: plain functions on tensors.
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """A contiguous tensor the backend takes: on gloo a CUDA tensor goes
    through host memory (gloo's collectives take CPU tensors)."""

    if g.backend == "gloo" and x.device.type == "cuda":
        return x.detach().to("cpu", copy=True)
    return x.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(x: torch.Tensor, g: SeqGroup, op) -> torch.Tensor:
    buf = _staged(x, g)
    dist.all_reduce(buf, op=op, group=g.group)
    return buf.to(x.device)


def psum(x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (``jax.lax.psum``); ``x``
    unchanged, the result on its device."""

    return _all_reduce(x, g, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """Elementwise max of ``x`` over the group's ranks (``jax.lax.pmax``)."""

    return _all_reduce(x, g, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order
    (``jax.lax.all_gather``), on ``x``'s device."""

    buf = _staged(x, g)
    parts = [torch.empty_like(buf) for _ in range(g.size)]
    dist.all_gather(parts, buf, group=g.group)
    return torch.stack(parts).to(x.device)


class _AllGatherGrad(torch.autograd.Function):
    """``all_gather`` whose backward is the gradient of the sum of every
    rank's loss: the gathered gradients summed over the ranks, this rank's
    slice kept (a reduce-scatter, written as an all-reduce and a slice so
    that it runs on gloo and NCCL alike)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
        ctx.g = g
        return all_gather(x, g)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = ctx.g
        return psum(grad, g)[g.rank], None


def all_gather_grad(x: torch.Tensor, g: SeqGroup) -> torch.Tensor:
    """``all_gather`` with a gradient: (size, *x.shape). The backward holds
    for a loss that is the sum of the ranks' losses (a rank whose loss is
    replicated over the group scales it by 1 / size)."""

    return _AllGatherGrad.apply(x, g)


def neighbour_halos(head: torch.Tensor, tail: torch.Tensor, g: SeqGroup) -> "tuple[torch.Tensor, torch.Tensor]":
    """(from_left, from_right): the left neighbour's ``tail`` and the right
    neighbour's ``head`` (zeros at the group's two ends), the two
    ``ppermute`` shifts of the JAX code as one ``all_gather`` of the
    flattened halos."""

    payload = torch.cat([head.reshape(-1), tail.reshape(-1)])
    gathered = all_gather(payload, g)
    n_head = head.numel()
    if g.rank > 0:
        from_left = gathered[g.rank - 1, n_head:].reshape(tail.shape)
    else:
        from_left = torch.zeros_like(tail)
    if g.rank < g.size - 1:
        from_right = gathered[g.rank + 1, :n_head].reshape(head.shape)
    else:
        from_right = torch.zeros_like(head)
    return from_left, from_right


# ---------------------------------------------------------------------------
# Launcher: world_size ranks from one process.
# ---------------------------------------------------------------------------

def _rank_main(
    rank: int,
    fn: Callable,
    args: tuple,
    world_size: int,
    folder: str,
    backend: "str | None",
    device: str,
    timeout_s: float,
    threads: int,
) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    g = make_group(rank, world_size, Path(folder) / "store", backend=backend, device=device, timeout_s=timeout_s)
    try:
        result = fn(g, *args)
        with open(Path(folder) / f"result_{rank}.pkl", "wb") as fh:
            pickle.dump(result, fh, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable[..., Any],
    world_size: int,
    args: tuple = (),
    *,
    backend: "str | None" = None,
    device: "str | torch.device" = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` new processes (spawned,
    ``torch.multiprocessing``), one rank each, joined through a file store
    in a temporary directory; return the ranks' return values in rank
    order.

    ``fn`` must be importable by name (a module-level function) and its
    return value picklable. Ranks on the CPU share this process's torch
    threads. A rank that raises makes ``spawn`` raise with
    that rank's traceback (the other ranks are stopped); a run that
    outlasts ``timeout_s`` is stopped and raises ``TimeoutError``. No
    partial result is returned."""

    import torch.multiprocessing as mp

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    device = str(device)
    threads = max(1, torch.get_num_threads() // world_size)  # CPU ranks share the caller's threads
    with tempfile.TemporaryDirectory(prefix="ta_spawn_") as folder:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, tuple(args), world_size, folder, backend, device, timeout_s, threads),
            nprocs=world_size,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} ran past {timeout_s:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(5.0)
                    if proc.is_alive():
                        proc.kill()
        results = []
        for rank in range(world_size):
            with open(Path(folder) / f"result_{rank}.pkl", "rb") as fh:
                results.append(pickle.load(fh))
        return results
