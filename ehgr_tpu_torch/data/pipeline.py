"""Host input pipeline (the port's own copy of
``ehgr_tpu/data/pipeline.py``): shuffled, batched, background-prefetched
loading of numpy samples.

The order and semantics are the JAX package's, so both give the same
batches in the same order: the shuffle is ``default_rng(seed + epoch)``,
``drop_last`` keeps batch shapes fixed, a thread pool of ``num_workers``
decodes one batch at a time into a queue of ``prefetch`` batches, a worker's
exception is re-raised in the consumer, and an abandoned iterator stops
its producer.  ``torch.utils.data.DataLoader`` is not used: its order and
worker seeding differ.  Batches stay numpy uint8; the caller uploads them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        if key == "paths":
            out[key] = [s[key] for s in samples]
        else:
            out[key] = np.stack([s[key] for s in samples], axis=0)
    return out


class Loader:
    """Iterable over collated batches with background prefetch.

    ``drop_last=True`` keeps every batch the same shape."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Shuffle the next pass as pass ``epoch`` (counted from 0): a
        resumed trainer sees the batches of an uninterrupted run."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _batches_of_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        cut = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:cut]
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches_of_indices()
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def _put(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            # Worker exceptions are shipped to the consumer and re-raised
            # there (torch DataLoader semantics); the sentinel ALWAYS
            # follows, so the consumer can never block forever on a dead
            # producer.  `stop` is set when the consumer abandons the
            # iterator early (e.g. max_steps-bounded epochs), so stale
            # producers exit instead of parking on a full queue.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                        if not _put(collate(samples)):
                            return
            except BaseException as e:  # noqa: BLE001 — relayed, not dropped
                _put(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
