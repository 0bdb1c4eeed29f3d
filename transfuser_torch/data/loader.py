"""Threaded prefetching data loader (counterpart of
transfuser_tpu/data/loader.py).

Replaces the reference's 8-worker fork-based torch DataLoader
(train.py:156-163) with a thread pool and a reorder heap: while the card
runs step N, later batches are decoded and copied. Deterministic per-epoch
shuffling mirrors DistributedSampler.set_epoch (train.py:191-193); for the
same seed and epoch the batches come in the JAX loader's order. Under data
parallelism each process loads its shard (``shard_rank`` of
``shard_count``: the data index and the data axis' size, so the model
ranks of one data index load the same rows): shuffle, every
``shard_count``-th index from ``shard_rank``, then drop the last partial
batch, as the JAX loader does.
"""

from __future__ import annotations

import heapq
import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .dataset import collate


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. For a CUDA device the array is
    first copied into pinned memory, so the host->device copy is
    asynchronous (``non_blocking``): a copy from pageable memory would hold
    the calling thread until the card had run everything queued before
    it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pinned_put(device) -> Callable[[Dict[str, np.ndarray]], Dict]:
    """A loader's ``device_put``: collated host arrays -> tensors on
    ``device`` (``to_device`` per key)."""
    device = torch.device(device)
    return lambda batch: {k: to_device(v, device) for k, v in batch.items()}


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 device_put: Optional[Callable] = None,
                 shard_rank: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.device_put = device_put
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.shard_rank::self.shard_count]
        if self.drop_last:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        return [idx[i:i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)]

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard_count
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches()
        task_q: "queue.Queue" = queue.Queue()
        done_q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch + self.num_workers)
        for pos, b in enumerate(batches):
            task_q.put((pos, b))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    pos, sample_ids = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = collate([self.dataset[i] for i in sample_ids])
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                except Exception as e:  # surfaced in the consumer
                    batch = e
                while not stop.is_set():
                    try:
                        done_q.put((pos, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # reorder out-of-order completions with a min-heap
        pending: list = []
        next_pos = 0
        try:
            while next_pos < len(batches):
                while not pending or pending[0][0] != next_pos:
                    heapq.heappush(pending, done_q.get())
                _, batch = heapq.heappop(pending)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                next_pos += 1
        finally:
            stop.set()
