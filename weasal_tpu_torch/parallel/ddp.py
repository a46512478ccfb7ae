"""Data-parallel training and voting: one process per rank.

Counterpart of weasal_tpu/parallel/mesh.py:28-92 (`make_mesh`,
`shard_batch`, `replicate`, `shard_trainer`). The JAX package runs one
program over a global batch whose sphere axis is split over a 1-D mesh
(`P('data')`): XLA partitions every reduction, so BatchNorm's batch
statistics, every loss's normalisation, the contrast loss's draw and the
dropout mask are those of the global batch, and the sharded gradient
equals the single-device one (tests/test_parallel.py:50-76). The port
computes the same thing with PyTorch's process model: one process per
rank, `torch.distributed` between them (NCCL on cards, gloo on the CPU),
rank r holding the contiguous spheres [r*B/W, (r+1)*B/W) of every
global batch of B spheres.

- Rendezvous is a `FileStore` in a fresh temporary directory: nothing
  listens on a port, and the card's machine has no network.
- `spawn` starts W ranks with `torch.multiprocessing` and joins them
  with a deadline: a rank that raises or hangs ends every rank and fails
  the call; no rank trains on alone.
- Every sum over the sphere axis goes through `global_sum` (`GlobalSum`
  under a group; `global_sums` takes several in one collective):
  BatchNorm's count with its sum, then its squared deviations, the
  losses' numerators and denominators, the accuracy, the contrast loss's
  draw, drawn rows and class sums. The dropout mask of rank r draws the
  threefry counters of its own slice of the global mask
  (`sphere_offset`).
- The gradient rule. Every rank computes the same global loss from the
  reduced sums and backpropagates it. `GlobalSum`'s backward all-reduces
  the cotangent, so each rank's share of the gradient of a rank-local
  tensor arrives W times too large (the W ranks' equal cotangents are
  summed); `all_reduce_grads` then averages the parameters' gradients
  over the ranks, which divides the factor back out. The result equals
  the single-process gradient of the global batch on every rank, so the
  clipping (by global norm or by value) and the update run on equal
  gradients and the parameters stay equal across ranks. A parameter that
  entered the loss only after the sums would carry its full gradient on
  every rank, and the average keeps it.
- `gather_spheres` all-gathers per-sphere outputs in sphere order, so
  that every rank applies the same sequential vote update and the vote
  buffers stay replicated (weasal_tpu/train/vote.py:93-100).
- Without a group every helper is the identity and nothing else runs:
  the single-process path is the one it was.

Why not `nn.parallel.DistributedDataParallel`: its reducer hooks run
outside the step that `train/graphs.StepGraph` captures (the whole step,
update included, is one CUDA graph); the port's SGD is already one
hand-written `_foreach` step (train/optim.py), which takes one flat
all-reduce before it; and DDP keeps BatchNorm's statistics and every
loss's mean per rank, which computes another function than the JAX
package's global batch.

The current group is process state, as `torch.distributed`'s default
group is: a process is one rank, and `init` / `shutdown` set and clear it.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# Seconds a collective waits before it fails (a dead peer ends the call)
COLLECTIVE_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class ParallelContext:
    """This process's place in the group: rank r of `world`, the backend
    of its tensor collectives and the device of its model."""
    rank: int
    world: int
    backend: str
    device: torch.device

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; the other ranks only read."""
        return self.rank == 0


_CONTEXT: Optional[ParallelContext] = None
_HOST_GROUP = None      # gloo group for barriers and host objects


def current() -> Optional[ParallelContext]:
    """The process's ParallelContext, or None when it runs alone."""
    return _CONTEXT


def is_writer() -> bool:
    """True alone and on rank 0."""
    return _CONTEXT is None or _CONTEXT.is_writer


def resolve_world(devices, device) -> int:
    """Ranks for a `data_parallel_devices` / `--devices` value, as the
    JAX package reads it (weasal_tpu/train/trainer.py:133-136): 0, 1 and
    None mean one; -1 means every visible card. Asking for more cards
    than exist raises with both counts, as `make_mesh` does
    (weasal_tpu/parallel/mesh.py:33-40)."""
    n = int(devices or 0)
    device = torch.device(device)
    available = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
    if n == -1:
        if device.type != "cuda":
            raise ValueError("data_parallel_devices = -1 means every "
                             "visible card; on the CPU give a rank count")
        n = available
    if n < -1:
        raise ValueError(f"data_parallel_devices must be -1 or >= 0, not "
                         f"{n}")
    n = max(n, 1)
    if n > 1 and device.type == "cuda" and device.index is None \
            and n > available:
        raise ValueError(f"requested {n} data-parallel devices but only "
                         f"{available} are available")
    return n


def rank_device(device, rank: int) -> torch.device:
    """Rank r's device: `cuda:r` for a bare "cuda", else `device` itself
    (ranks that share one named card, or the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def default_backend(device) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU and for ranks
    that share a named card (NCCL refuses two ranks on one card)."""
    device = torch.device(device)
    return "nccl" if device.type == "cuda" and device.index is None \
        else "gloo"


def init(rank: int, world: int, backend: str, device, store_path: str
         ) -> ParallelContext:
    """Join the group through the FileStore at `store_path` and make it
    the process's context."""
    global _CONTEXT, _HOST_GROUP
    if _CONTEXT is not None:
        raise RuntimeError("this process already belongs to a group")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        # Collectives inside captured CUDA graphs: no asynchronous error
        # handling (torch.cuda.graphs' notes for NCCL >= 2.9.6)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    store = dist.FileStore(store_path, world)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout, **kwargs)
    _HOST_GROUP = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend != "gloo" else dist.group.WORLD)
    _CONTEXT = ParallelContext(rank, world, backend, device)
    return _CONTEXT


def shutdown() -> None:
    """Leave the group (a no-op alone)."""
    global _CONTEXT, _HOST_GROUP
    if _CONTEXT is None:
        return
    _CONTEXT = None
    _HOST_GROUP = None
    dist.destroy_process_group()


@contextlib.contextmanager
def group(rank: int, world: int, backend: str, device, store_path: str):
    """`init` for the block's duration, then `shutdown`."""
    ctx = init(rank, world, backend, device, store_path)
    try:
        yield ctx
    finally:
        shutdown()


# ----------------------------------------------------------------------
# Processes
# ----------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world: int, device: str,
               store_path: str, args: Sequence,
               threads: Optional[int]) -> None:
    if rank:
        sys.stdout = open(os.devnull, "w")
    if threads:
        torch.set_num_threads(int(threads))
    with group(rank, world, default_backend(device),
               rank_device(device, rank), store_path):
        fn(*args)


def spawn(fn: Callable, world: int, device="cuda", args: Sequence = (),
          timeout: Optional[float] = None,
          threads: Optional[int] = None) -> None:
    """Run `fn(*args)` in `world` new processes, one per rank, each inside
    its group (`current()` gives its context). Rank r runs on
    `rank_device(device, r)` with the backend `default_backend(device)`.
    `fn` and `args` must pickle (a module-level function). Returns when
    every rank has returned; raises when a rank raises or dies (every
    other rank is ended first) or when `timeout` seconds pass (None: no
    deadline, as a training run needs). The ranks above 0 print nothing.
    Each rank sets its torch intra-op thread count to `threads`, by
    default on the CPU this process's count over the ranks (ranks that
    each take every core's threads oversubscribe the CPU: two such ranks
    ran a CPU test 15 times slower)."""
    import torch.multiprocessing as mp
    if threads is None and torch.device(device).type == "cpu":
        threads = max(torch.get_num_threads() // world, 1)
    store_dir = tempfile.mkdtemp(prefix="weasal_ddp_")
    try:
        procs = mp.start_processes(
            _rank_main, args=(fn, world, str(device),
                              os.path.join(store_dir, "store"), tuple(args),
                              threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not procs.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} data-parallel ranks did not finish in "
                        f"{timeout:g} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
            for p in procs.processes:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------

def _through_host(t: torch.Tensor) -> bool:
    """Gloo collectives take CPU tensors here: a CUDA tensor goes through
    the host."""
    return _CONTEXT.backend == "gloo" and t.is_cuda


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks in place (a buffer of the caller's);
    returns `t`."""
    if _through_host(t):
        host = t.cpu()
        dist.all_reduce(host)
        return t.copy_(host)
    dist.all_reduce(t)
    return t


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The SUM over the ranks of `t`, as a new tensor."""
    if _through_host(t):
        host = t.detach().cpu()
        dist.all_reduce(host)
        return host.to(t.device)
    return _all_reduce_(t.detach().clone())


class GlobalSum(torch.autograd.Function):
    """All-reduce (SUM) over the ranks; the backward all-reduces the
    cotangent (see the gradient rule in the module docstring)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks (differentiable); `x` itself alone."""
    if _CONTEXT is None:
        return x
    return GlobalSum.apply(x)


def global_sums(*xs: torch.Tensor) -> tuple:
    """Each of `xs` (of one dtype) summed over the ranks, through one
    collective (`global_sum` of their concatenation); `xs` alone."""
    if _CONTEXT is None:
        return xs
    flat = global_sum(torch.cat([x.reshape(-1) for x in xs]))
    return tuple(part.view_as(x) for part, x in
                 zip(flat.split([x.numel() for x in xs]), xs))


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x`'s elements over every rank's `x` (all ranks hold
    the same shape); `x.mean()` alone."""
    if _CONTEXT is None:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * _CONTEXT.world)


def sphere_offset(n: int) -> int:
    """The first flat index of this rank's slice of a global tensor whose
    leading axis is the sphere axis and whose local part has `n`
    elements (0 alone)."""
    return 0 if _CONTEXT is None else _CONTEXT.rank * int(n)


def gather_spheres(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order: the
    global batch's per-sphere rows in sphere order (`t` alone)."""
    if _CONTEXT is None:
        return t
    if _CONTEXT.backend == "gloo":
        src = t.detach().cpu().contiguous()
        parts = [torch.empty_like(src) for _ in range(_CONTEXT.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)
    src = t.detach().contiguous()
    out = torch.empty((_CONTEXT.world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src)
    return out


def all_reduce_grads(model: torch.nn.Module) -> None:
    """Average the parameters' gradients over the ranks in one flat
    collective (a missing gradient counts as zero and becomes one);
    nothing alone. The averages are copied back into the gradients' own
    tensors: with `.grad` made views into the flat buffer, one NCCL
    rank's graphed WL epoch was no longer bit-equal to the epoch with no
    group over 48 replayed steps (chip_smoke.py phase 14 (b)), though a
    single replayed step stayed equal."""
    if _CONTEXT is None:
        return
    params = list(model.parameters())
    flat = _all_reduce_(torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in params]))
    flat.div_(_CONTEXT.world)
    views = [v.view_as(p) for p, v in
             zip(params, flat.split([p.numel() for p in params]))]
    for p, v in zip(params, views):
        if p.grad is None:
            p.grad = v.clone()
    torch._foreach_copy_([p.grad for p in params], views)


def broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite each tensor with rank 0's values, in place."""
    if _CONTEXT is None:
        return
    with torch.no_grad():
        for t in tensors:
            if _through_host(t):
                host = t.detach().cpu()
                dist.broadcast(host, 0)
                t.copy_(host)
            else:
                dist.broadcast(t.data, 0)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank (any picklable value)."""
    if _CONTEXT is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def barrier() -> None:
    """Wait until every rank reaches this call (host-side)."""
    if _CONTEXT is not None:
        dist.barrier(group=_HOST_GROUP)


@contextlib.contextmanager
def rank0_first():
    """Rank 0 runs the block first (it writes caches and ledgers), the
    other ranks after it has left the block (they read what it wrote)."""
    if _CONTEXT is not None and not _CONTEXT.is_writer:
        barrier()
    yield
    if _CONTEXT is not None and _CONTEXT.is_writer:
        barrier()


def shard_bounds(n: int):
    """(lo, hi) of this rank's contiguous spheres among `n`, as `P('data')`
    places them ((0, n) alone). Raises when `n` does not divide by the
    world size."""
    if _CONTEXT is None:
        return 0, n
    if n % _CONTEXT.world:
        raise ValueError(f"{n} spheres do not split over {_CONTEXT.world} "
                         "ranks")
    b = n // _CONTEXT.world
    return _CONTEXT.rank * b, (_CONTEXT.rank + 1) * b


def shard(arrays: Mapping[str, Any]) -> dict:
    """This rank's rows (`shard_bounds`) of each array's leading (sphere)
    axis; the arrays themselves alone."""
    out = {}
    for k, v in arrays.items():
        if v is None or _CONTEXT is None:
            out[k] = v
            continue
        lo, hi = shard_bounds(v.shape[0])
        out[k] = v[lo:hi]
    return out


class ShardedSource:
    """A batch source whose `next_batch` gives this rank's rows of the
    global batch and the global batch's metas: every rank runs the same
    sampler (potentials, region buffer, plan bucket) on the same rng, and
    decides the same skips from the same metas."""

    def __init__(self, source):
        self.source = source

    def next_batch(self, rng, augment=None):
        arrays, metas = self.source.next_batch(rng, augment=augment)
        return shard(arrays), metas

    def __getattr__(self, name):
        return getattr(self.source, name)


def round_batch_num(config) -> int:
    """Resolve `config.data_parallel_devices` against the current group
    and round `config.batch_num` up to a multiple of the world size,
    printing the JAX trainer's line (weasal_tpu/train/trainer.py:131-141).
    Returns the world size. A count above 1 with no group, or one that
    differs from the group's, raises: ranks come from `spawn` (the entry
    points' `--devices`)."""
    ctx = _CONTEXT
    want = int(getattr(config, "data_parallel_devices", 0) or 0)
    world = 1 if ctx is None else ctx.world
    if want == -1:
        want = world
    if max(want, 1) != world:
        raise RuntimeError(
            f"config.data_parallel_devices = {want} but this process runs "
            f"{'alone' if ctx is None else f'in a group of {world}'}; start "
            "the ranks with weasal_tpu_torch.parallel.ddp.spawn (the entry "
            "points' --devices)")
    if world > 1:
        config.data_parallel_devices = world
        if config.batch_num % world:
            new_bn = -(-config.batch_num // world) * world
            print(f"batch_num {config.batch_num} -> {new_bn} "
                  f"(divisible by {world} data-parallel devices)")
            config.batch_num = new_bn
    return world

