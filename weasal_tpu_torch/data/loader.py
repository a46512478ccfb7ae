"""Background batch prefetching for the training loop.

Counterpart of weasal_tpu/data/loader.py:27-165 (`BatchPrefetcher`, one
step per batch):

- a producer thread runs the source's `next_batch` ahead of the consumer
  and queues up to `prefetch` ready batches; it is the only thread that
  touches the dataset's state (potentials, the region buffer), so the
  sampler keeps one writer and needs no lock;
- on a CUDA device the producer turns each batch's arrays into tensors in
  page-locked host memory, and the consumer issues `non_blocking` copies
  to the device just before the step, so no synchronous pageable copy
  sits on the consumer's path;
- the resident tensors (already on the device) are merged in after the
  copy; `noise_seed` stays a numpy array (its seeds are read on the host);
- an error in the producer is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# Batch keys that stay numpy on the host
HOST_KEYS = ("noise_seed",)
# Ready batches the producer may hold ahead of the consumer
PREFETCH = 2


class BatchPrefetcher:
    """Iterator of (batch dict of tensors on `device`, metas)."""

    def __init__(self, source, num_batches: int, device,
                 rng: np.random.Generator, augment: Optional[bool] = None,
                 extra_arrays: Optional[Dict[str, torch.Tensor]] = None):
        self.source = source
        self.num_batches = num_batches
        self.device = torch.device(device)
        self.rng = rng
        self.augment = augment
        self.extra_arrays = extra_arrays
        self._pin = self.device.type == "cuda"
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _host_tensors(self, batch: Dict) -> Dict:
        out = {}
        for k, v in batch.items():
            if k in HOST_KEYS or v is None:
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self._pin else t
        return out

    def _produce(self):
        try:
            for _ in range(self.num_batches):
                if self._closed:
                    break
                batch, metas = self.source.next_batch(self.rng,
                                                      augment=self.augment)
                self._queue.put((self._host_tensors(batch), metas))
        except BaseException as e:                     # raised in consumer
            self._error = e
        finally:
            self._queue.put(None)

    def _place(self, batch: Dict) -> Dict:
        out = {k: (v if k in HOST_KEYS or v is None
                   else v.to(self.device, non_blocking=True))
               for k, v in batch.items()}
        if self.extra_arrays is not None:
            out.update(self.extra_arrays)
        return out

    def __iter__(self) -> Iterator:
        for _ in range(self.num_batches):
            item = self._queue.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            batch, metas = item
            yield self._place(batch), metas
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
