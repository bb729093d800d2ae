"""Background staging of host batches (port of ``PrefetchIterator``,
``ImageDecodePool`` and ``default_image_pool`` in
imagetranslate_tpu/data/prefetch.py).

A worker thread pulls items from the source and runs ``transform`` on each
(batch padding and the host-to-device copy), so the staging of batch N+1
overlaps the decode of batch N. ``depth`` bounds the finished items waiting
in the queue. An exception in the worker is raised to the consumer at its
next ``__next__``. ``close()`` (or the context manager) stops the worker.
Spans (``utils/profiling.py``): ``data.stage`` around ``transform`` on the
worker thread, ``data.wait`` around the consumer's wait for an item.

``ImageDecodePool`` decodes a batch's image files on a thread pool, in order
(Pillow releases the GIL while it decodes and resizes).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from imagetranslate_tpu_torch.utils.profiling import span

_SENTINEL = object()


class PrefetchIterator:
    def __init__(self, source: Iterable, transform: Optional[Callable] = None,
                 depth: int = 3):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._source = iter(source)
        self._transform = transform
        self._thread = threading.Thread(target=self._run, name="prefetch",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    with span("data.stage"):
                        item = self._transform(item)
                self._put(item)
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            self._put(e)

    def _put(self, item):
        # A bounded put that still notices close().
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        with span("data.wait"):
            item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        self._stop.set()
        # Drain, so a worker blocked on put() sees the stop flag.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ImageDecodePool:
    """Thread pool over ``data.images.load_image``; a batch comes back in the
    order of its paths. One instance per process is plenty (see
    ``default_image_pool``)."""

    def __init__(self, workers: Optional[int] = None):
        from concurrent.futures import ThreadPoolExecutor

        if workers is None:
            workers = min(16, max(2, (os.cpu_count() or 4) - 1))
        self.workers = workers
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="imgdec")

    def decode(self, paths: Sequence[str], root: str = "", size: int = 224,
               resize_min: Optional[int] = None,
               raw: bool = False) -> np.ndarray:
        """Decode and resize ``paths`` in parallel -> [N, size, size, 3]:
        normalised float32, or uint8 with ``raw=True``."""
        from imagetranslate_tpu_torch.data.images import load_image

        full = [os.path.join(root, p) if root else p for p in paths]
        futs = [self._pool.submit(load_image, p, size, resize_min, raw)
                for p in full]
        return np.stack([f.result() for f in futs])

    def shutdown(self):
        self._pool.shutdown(wait=False)


_default_pool: Optional[ImageDecodePool] = None
_default_pool_lock = threading.Lock()


def default_image_pool() -> ImageDecodePool:
    global _default_pool
    if _default_pool is None:
        with _default_pool_lock:
            if _default_pool is None:
                _default_pool = ImageDecodePool()
    return _default_pool
