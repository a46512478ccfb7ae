"""Background batch prefetching for the training loop, and the sources
of host-pyramid batches.

Counterpart of weasal_tpu/data/loader.py:27-165 (`BatchPrefetcher`) and
:168-211 (`ParallelSphereBuilder`), with `HostPyramidSource`, which
turns the host batches of a dataset or a `ParallelSphereBuilder` into
the flat dicts the prefetcher and the step graphs carry.
`BatchPrefetcher`:

- a producer thread runs the source's `next_batch` ahead of the consumer
  and queues up to `PREFETCH` ready items; it is the only thread that
  touches the dataset's state (potentials, the region buffer), so the
  sampler keeps one writer and needs no lock;
- on a CUDA device the producer turns each batch's arrays into tensors in
  page-locked host memory, so the consumer's copies to the device are
  `non_blocking` and no synchronous pageable copy sits on its path;
- with `pack=K` it stacks K batches into one [K, ...] host pack (a tail
  pack holds the n < K batches left; the trainer runs those one step a
  replay, so no masked step is padded in), drops batches that `keep_fn`
  refuses before packing (they still use up `num_batches`, as the
  unpacked loop's skip does) and never mixes the buckets of a bucketed
  source in one pack; the consumer
  copies each pack, or one step of it, into the static input tensors of
  its step (`copy_batch`);
- without `pack` it yields single batches already on the device, with
  the resident tensors (on the device already) merged in;
- an error in the producer is raised in the consumer;
- the producer's spans (utils/profiling): `batch.sample` (the source's
  `next_batch`), `batch.pin` (a pack's stacking and its tensors pinned),
  `batch.put_wait` (blocked on a full queue), and the counts
  `batch.produced` (batches queued) and `batch.skipped` (refused by
  `keep_fn`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from weasal_tpu_torch.data.batching import (build_sphere_pyramid,
                                            sphere_batch)
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.utils.profiling import counter, span

# Ready items the producer may hold ahead of the consumer
PREFETCH = 2


def copy_batch(dst: Mapping[str, torch.Tensor],
               src: Mapping[str, torch.Tensor]) -> None:
    """Copy the host tensors `src` into the preallocated device tensors
    `dst`, key by key, `non_blocking` on the current stream (no host
    synchronization). Raises on a missing key or on a shape or dtype that
    differs from the static tensor's: a captured graph replays one
    shape."""
    for key, static in dst.items():
        value = src.get(key)
        if value is None:
            raise KeyError(f"batch has no {key!r} for the static inputs")
        if tuple(value.shape) != tuple(static.shape) \
                or value.dtype != static.dtype:
            raise ValueError(
                f"batch {key!r} is {tuple(value.shape)} {value.dtype}, the "
                f"static input is {tuple(static.shape)} {static.dtype}")
        static.copy_(value, non_blocking=True)


class BatchPrefetcher:
    """Iterator of (batch, metas): with `pack`, (host pack, [metas of each
    real step]); without, (batch dict of tensors on `device`, metas)."""

    def __init__(self, source, num_batches: int, device,
                 rng: np.random.Generator, augment: Optional[bool] = None,
                 extra_arrays: Optional[Dict[str, torch.Tensor]] = None,
                 pack: Optional[int] = None,
                 keep_fn: Optional[Callable] = None):
        self.source = source
        self.num_batches = num_batches
        self.device = torch.device(device)
        self.rng = rng
        self.augment = augment
        self.extra_arrays = extra_arrays
        self.pack = None if pack is None else max(int(pack), 1)
        self.keep_fn = keep_fn
        self._pin = self.device.type == "cuda"
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _host_tensor(self, v: np.ndarray) -> torch.Tensor:
        if v.dtype == np.uint32:            # noise seeds: no uint32 math
            v = v.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory() if self._pin else t

    def _host_tensors(self, batch: Dict) -> Dict:
        # every key, the noise seeds included, becomes a tensor, so that
        # every input of a step can live in a captured graph's tensors
        return {k: (None if v is None else self._host_tensor(v))
                for k, v in batch.items()}

    def _put(self, item, batches: int) -> None:
        with span("batch.put_wait"):
            self._queue.put(item)
        counter("batch.produced", batches)

    def _emit_pack(self, buf, buf_metas):
        with span("batch.pin"):
            stacked = {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            item = (self._host_tensors(stacked), buf_metas)
        self._put(item, len(buf))

    def _produce(self):
        try:
            bufs = {}
            for _ in range(self.num_batches):
                if self._closed:
                    break
                with span("batch.sample"):
                    batch, metas = self.source.next_batch(
                        self.rng, augment=self.augment)
                if self.keep_fn is not None and not self.keep_fn(metas):
                    counter("batch.skipped")
                    continue
                if self.pack is None:
                    with span("batch.pin"):
                        item = (self._host_tensors(batch), metas)
                    self._put(item, 1)
                    continue
                tag = metas[0].get("bucket", "large") if metas else "large"
                buf, buf_metas = bufs.setdefault(tag, ([], []))
                buf.append(batch)
                buf_metas.append(metas)
                if len(buf) == self.pack:
                    self._emit_pack(buf, buf_metas)
                    bufs.pop(tag)
            for buf, buf_metas in bufs.values():
                if buf and not self._closed:
                    self._emit_pack(buf, buf_metas)
        except BaseException as e:                     # raised in consumer
            self._error = e
        finally:
            self._queue.put(None)

    def _place(self, batch: Dict) -> Dict:
        out = {k: (None if v is None
                   else v.to(self.device, non_blocking=True))
               for k, v in batch.items()}
        if self.extra_arrays is not None:
            out.update(self.extra_arrays)
        return out

    def __iter__(self) -> Iterator:
        # With keep_fn or pack the producer may emit fewer items than
        # num_batches; its None ends the iteration either way
        for _ in range(self.num_batches):
            item = self._queue.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            batch, metas = item
            yield (batch if self.pack else self._place(batch)), metas
        self._thread.join()

    def close(self):
        """Stop the producer after its current batch and drain the queue."""
        self._closed = True
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()


class ParallelSphereBuilder:
    """Host batches whose sphere pyramids a thread pool builds.

    The spheres are sampled in the calling thread (the potentials keep
    one writer); then one seed a sphere is drawn from the caller's rng
    (`integers(0, 2**31, size=B)`), each pyramid is built from its own
    `default_rng(seed)` in a worker, and `assemble_batch` takes the
    caller's rng, as the JAX package's builder does. The native library
    and numpy release the GIL in their loops. The pool starts at the
    first batch after construction or `close()`.
    """

    def __init__(self, dataset, max_workers: int = 4):
        self.dataset = dataset
        self.max_workers = max_workers
        self.pool = None

    def next_batch(self, rng, plan, num_spheres=None, augment=None,
                   own=None):
        """(PyramidBatch, metas) of B spheres; with `own` = (lo, hi) the
        batch of spheres [lo, hi) only, from the draws of all B (see
        `sphere_batch`), and the metas of all B."""
        ds = self.dataset
        b = num_spheres or ds.config.batch_num
        if augment is None:
            augment = ds.split == "training"
        payloads = [ds.sample_sphere(rng, augment=augment,
                                     max_points=plan.num_points[0])
                    for _ in range(b)]
        seeds = rng.integers(0, 2 ** 31, size=b)
        lo, hi = own or (0, b)

        def build(args):
            payload, seed = args
            return build_sphere_pyramid(
                payload["points"], ds.config,
                rng=np.random.default_rng(int(seed)),
                max_neighbors=plan.conv_neighbors,
                max_pool_neighbors=plan.pool_neighbors)

        if self.pool is None:
            self.pool = ThreadPoolExecutor(max_workers=self.max_workers)
        pyramids = list(self.pool.map(build, zip(payloads[lo:hi],
                                                 seeds[lo:hi])))
        return sphere_batch(payloads, pyramids, plan, ds.config.num_classes,
                            rng, own=own)

    def close(self):
        """Stop the workers; a later batch starts new ones."""
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            self.pool = None


class HostPyramidSource:
    """The host-pyramid input of a loop: `next_batch(rng, augment)` gives
    (`PyramidBatch.arrays()` of a host batch, metas), its pyramids built
    by `dataset.next_batch`, or with `threads` > 1 by a
    `ParallelSphereBuilder` of at most 8 workers (the JAX trainer's
    choice, trainer.py:629-633). Under a data-parallel group every rank
    samples the global batch (the same draws) but builds only its own
    spheres' pyramids, and gets its rows with the global metas."""

    def __init__(self, dataset, plan, threads: int = 1):
        self.dataset = dataset
        self.plan = plan
        threads = max(int(threads or 1), 1)
        self.builder = (ParallelSphereBuilder(dataset, min(threads, 8))
                        if threads > 1 else dataset)
        # Host seconds spent building batches, for callers that report it
        # (this source's own; the producer's batch.sample spans hold every
        # source's)
        self.seconds = 0.0
        self.batches = 0

    def next_batch(self, rng, augment=None):
        t0 = time.perf_counter()
        own = ddp.shard_bounds(self.dataset.config.batch_num)
        batch, metas = self.builder.next_batch(rng, self.plan,
                                               augment=augment, own=own)
        self.seconds += time.perf_counter() - t0
        self.batches += 1
        return batch.arrays(), metas

    def close(self):
        """Stop the builder's workers, if it has any."""
        if isinstance(self.builder, ParallelSphereBuilder):
            self.builder.close()
