"""Data loader with background prefetching.

A small threaded prefetcher over a map-style dataset: HDF5 reads release
the interpreter lock, so one worker thread overlaps host IO with device
work. Batches are collated numpy arrays; the rollout moves them to the
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .stats import numpy_collate


class DataLoader:
    """Iterable over collated numpy batches of a map-style dataset.

    Args:
        dataset: object with ``__len__`` and ``__getitem__ -> tuple of np``.
        batch_size: samples per batch.
        shuffle: reshuffle indices at the start of every epoch.
        drop_last: drop the trailing partial batch.
        rng: numpy Generator driving the shuffle (seeded by the caller).
        num_prefetch: max batches buffered ahead of the consumer.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        rng: Optional[np.random.Generator] = None,
        num_prefetch: int = 2,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.num_prefetch = num_prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        stop = len(order) - (len(order) % self.batch_size) if self.drop_last else len(order)
        for start in range(0, stop, self.batch_size):
            idxs = order[start : start + self.batch_size]
            yield numpy_collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self._epoch_batches():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # surfaced to the consumer below
                q.put(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early (``next(iter(loader))``) releases
            # the producer instead of leaving it blocked on a full queue
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def cycle(loader: DataLoader) -> Iterator:
    """Endless epoch-respecting iterator (reshuffles between epochs)."""
    while True:
        yield from loader
