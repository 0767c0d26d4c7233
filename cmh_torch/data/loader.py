"""Batched host data loading with background prefetch (counterpart of
``cmh_tpu/data/loader.py:25-148``).

A worker thread assembles batches of numpy arrays and queues up to
``_PREFETCH`` of them ahead of the consumer; ``num_workers > 0`` decodes
items with a thread pool. Batches have a fixed size: the ragged last batch
is padded with items wrapped from the start of the epoch's order, and
``valid`` marks the real rows. The shuffle draws from numpy's global
generator, as cmh_tpu's does, so one seed gives cmh_tpu's batch order.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

_PREFETCH = 2   # batches queued ahead of the consumer


class HostDataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # >0: decode items with a thread pool (PIL/numpy release the GIL for
        # the heavy parts)
        self.num_workers = num_workers
        self._pool = None

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _make_batch(self, idx: np.ndarray, size: int) -> Dict[str, np.ndarray]:
        if self.num_workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            items = list(self._pool.map(
                lambda i: self.dataset[int(i)], idx.tolist()
            ))
        else:
            items = [self.dataset[int(i)] for i in idx]
        images, captions, kpms, labels, indices = zip(*items)
        batch = {
            "image": np.stack(images).astype(np.float32),
            "text": np.stack(captions).astype(np.int32),
            "key_padding_mask": np.stack(kpms),
            "label": np.stack(labels).astype(np.float32),
            "index": np.asarray(indices, dtype=np.int32),
        }
        batch["valid"] = (np.arange(len(batch["index"])) < size)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        indices = np.random.permutation(n) if self.shuffle else np.arange(n)
        steps = []
        for start in range(0, n, self.batch_size):
            chunk = indices[start : start + self.batch_size]
            size = len(chunk)
            if size < self.batch_size:
                # pad the ragged final batch with samples wrapped from the
                # start of this epoch's order — distinct from the tail chunk
                # whenever the dataset has ≥ batch_size items (np.resize
                # cycles, so datasets SMALLER than a batch necessarily repeat
                # items); ``valid`` marks them, and eval drops them (the
                # DCMHT loss takes every row, as cmh_tpu's does)
                pad = np.resize(indices, self.batch_size - size)
                chunk = np.concatenate([chunk, pad])
            steps.append((chunk, size))

        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        sentinel = object()
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # abandoned iterators (e.g. `next(iter(loader))` shape probes)
            # must not leave this thread blocked on a full queue forever,
            # pinning the queued batches' memory per construction
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for chunk, size in steps:
                    if not put(self._make_batch(chunk, size)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # runs on GeneratorExit too (consumer dropped the iterator)
            stop.set()
