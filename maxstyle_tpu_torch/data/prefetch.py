"""Host-side input prefetching.

The port's copy of ``maxstyle_tpu/data/prefetch.py``. The reference overlaps
input work with compute via DataLoader workers + pin_memory
(train_adv…:119-125). Here the equivalent is a small background-thread
pipeline: host batches are assembled (and, through ``transform``, copied to
the device) ahead of time on a queue while the device executes the
asynchronously launched previous step, so the GPU never waits on numpy
slice stacking.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from maxstyle_tpu_torch.utils.profiling import span


class PrefetchIterator:
    """Wrap an iterable of host batches with an N-deep background queue."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._iterable = iterable
        self._depth = depth
        self._transform = transform

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err: list = []
        stop = threading.Event()  # set when the consumer stops iterating

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped; returns
            whether it was queued."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for item in self._iterable:
                    if self._transform is not None:
                        item = self._transform(item)
                    if not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("loader_wait"):
                    item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that breaks off early (or raises) releases the producer
            stop.set()
            t.join(timeout=60)


def prefetch(iterable: Iterable, depth: int = 2,
             transform: Optional[Callable] = None) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth, transform)
