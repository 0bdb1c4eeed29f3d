"""Device-resident dataset: upload once, gather batches on the card
(counterpart of transfuser_tpu/data/device_cache.py).

A dataset that fits in device memory crosses the host->device link once,
not once per epoch: the per-step "load" is an index into card-resident
tensors. The device tier of the reference's shared diskcache
(train.py:77-91).

Use with packed samples (data/pack.py) and augment=False: augmentation is
sampled at decode time, so a resident copy would freeze it (the same
constraint the disk/memory cache has, dataset.py). The train step's
unpack_batch widens the gathered uint8 rows on the card.

`fits(dataset, budget_bytes)` checks before committing; the training CLI
gives it 8 GB.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterator

import numpy as np
import torch

from .loader import to_device


def gather(store: Dict[str, torch.Tensor],
           idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` of every tensor in ``store``. uint16 (packed depth)
    goes through an int16 view: CUDA has no indexing kernel for uint16."""
    out = {}
    for k, v in store.items():
        if v.dtype == torch.uint16:
            out[k] = v.view(torch.int16)[idx].view(torch.uint16)
        else:
            out[k] = v[idx]
    return out


def sample_nbytes(sample: Dict[str, np.ndarray]) -> int:
    return sum(np.asarray(v).nbytes for v in sample.values())


def fits(dataset, budget_bytes: int) -> bool:
    if len(dataset) == 0:
        return False
    return sample_nbytes(dataset[0]) * len(dataset) <= budget_bytes


class DeviceCacheLoader:
    """Iterator interface matching PrefetchLoader (set_epoch / __iter__ /
    __len__); yields batch dicts of tensors on ``device``. For the same
    seed and epoch the batches hold the samples the JAX loader gathers,
    in its order. Single-process, as the JAX CLI uses it."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, log=None,
                 device="cuda"):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.device = torch.device(device)
        n = len(dataset)
        # decode into one host array per key, then one copy per key
        first = dataset[0]
        host: Dict[str, np.ndarray] = {
            k: np.empty((n,) + np.asarray(v).shape, np.asarray(v).dtype)
            for k, v in first.items()}
        for i in range(n):
            s = first if i == 0 else dataset[i]
            for k, v in s.items():
                host[k][i] = v
            if log and (i + 1) % 500 == 0:
                log(f"device-cache decode {i + 1}/{n}")
        self.upload_bytes = sum(v.nbytes for v in host.values())
        t0 = time.perf_counter()
        self.store = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t0
        self.n = n
        if log:
            log(f"device-cache resident: {n} samples, "
                f"{self.upload_bytes / 1e6:.0f} MB uploaded")

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n // self.batch_size if self.drop_last \
            else math.ceil(self.n / self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        order = to_device(idx, self.device)  # one copy per epoch
        for i in range(0, len(idx), self.batch_size):
            b = order[i:i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                break
            yield gather(self.store, b)
