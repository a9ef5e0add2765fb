"""Host-side batch prefetching (counterpart of
`nerf_lidar_tpu/train/prefetch.py`).

Worker threads build numpy batches ahead of the training loop and stage
them on the device, so the step never waits for ray generation or for a
host-to-device copy. Each worker has its own stream of batches (its own
`make_batch(w)` source, e.g. its own seeded `RayBatcher`), and `next()`
takes them in turn, worker 0, 1, ..., 0, 1, ...: the order of the batches
is fixed whatever the threads' timing.

On a CUDA device a worker copies each batch into its own pinned host
buffers (allocated once, reused for every batch), then to the device on a
side stream, and records an event; it waits for that copy before it
refills its buffers. `next()` makes the current stream wait on the event
and marks every tensor as used on it (`record_stream`), so that the caching
allocator does not hand a batch's memory to another tensor while the step
still reads it. On the CPU the tensors come straight from numpy.

A worker's exception is raised again by the next `next()` (the JAX
prefetcher's worker dies silently and its consumer then waits for ever).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# How long a blocked put / get sleeps before it looks at the stop flag and
# at the other workers' errors again.
_POLL_S = 0.05


class BatchPrefetcher:
    """Runs `make_batch(w)` in worker thread w (w < num_workers) and keeps
    up to `depth` batches staged on `device` ahead of `next()`; worker w
    holds at most its share of them, ceil((depth - w) / num_workers).

    rows: a slice of every array's leading axis (a data-parallel rank's
      rows of the global batch, `DataMesh.rows`): only those rows are
      staged; None stages the whole batch."""

    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 depth: int = 3, num_workers: int = 2,
                 device: torch.device = torch.device("cpu"),
                 rows: Optional[slice] = None):
        if not 1 <= num_workers <= depth:
            raise ValueError(f"need 1 <= num_workers <= depth, got "
                             f"{num_workers} workers for depth {depth}")
        self._make = make_batch
        self._device = torch.device(device)
        self._rows = rows
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=-(-(depth - w) // num_workers))
            for w in range(num_workers)]
        self._count = 0
        self._threads = [
            threading.Thread(target=self._worker, args=(w,), daemon=True,
                             name=f"prefetch-{w}")
            for w in range(num_workers)]
        for t in self._threads:
            t.start()

    def _stage(self, batch: Dict[str, np.ndarray], pinned: dict,
               stream) -> tuple:
        """(tensors on the device, the event after their copy or None)."""
        arrays = {k: np.asarray(v) if self._rows is None
                  else np.asarray(v)[self._rows] for k, v in batch.items()}
        if stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()}, None
        out = {}
        with torch.cuda.stream(stream):
            for k, v in arrays.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                buf = pinned.get(k)
                if buf is None or buf.shape != src.shape or \
                        buf.dtype != src.dtype:
                    buf = pinned[k] = torch.empty(
                        src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out[k] = buf.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, w: int):
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        pinned: dict = {}
        try:
            while not self._stop.is_set():
                staged, event = self._stage(self._make(w), pinned, stream)
                if event is not None:
                    # The pinned buffers are refilled only after this copy.
                    event.synchronize()
                if not self._put(self._queues[w], (staged, event)):
                    return
        except BaseException as e:  # raised again by next()
            if self._error is None:
                self._error = e

    def next(self) -> Dict[str, torch.Tensor]:
        """The next batch in worker order, on the device. Raises the first
        error of any worker."""
        q = self._queues[self._count % len(self._queues)]
        while True:
            if self._error is not None:
                raise self._error
            if self._stop.is_set():
                raise RuntimeError("BatchPrefetcher is closed")
            try:
                staged, event = q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                continue
        self._count += 1
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in staged.values():
                t.record_stream(current)
        return staged

    def close(self, timeout: float = 10.0) -> None:
        """Stop the workers, join them, drop what they staged."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
