"""Rotating-window device cache: augmented training at device-gather rate
(counterpart of transfuser_tpu/data/echo_cache.py).

The two fast input tiers both force augment=False (device_cache.py holds
ONE frozen decode resident; the disk cache freezes the rotation sampled
at write time), while the reference augments with +-20 degree rotations
(train.py:156-163) and the host decodes far slower than the card trains.

This loader keeps a WINDOW of freshly augmented samples resident on the
card and trains from gathers there, while one background thread
re-decodes dataset samples (fresh augmentation each decode) and the main
loop swaps them in chunk by chunk between steps:

  * the window is n_chunks tensors per key, not one: replacing a chunk is
    one upload and a rebinding of the chunk's slot, and the old tensors
    go back to the allocator once the steps queued on them have run,
  * each batch samples one chunk uniformly, then batch_size offsets
    without replacement inside it: chunks are i.i.d. random subsets of
    the dataset, so a batch is an unbiased subset sample,
  * every sample is consumed about (card rate / refresh rate) times
    before its slot is re-decoded with a new rotation: the data-echoing
    trade (Choi et al., "Faster Neural Network Training with Data
    Echoing"). The achieved echo factor is reported.

The draws use the JAX loader's streams (``default_rng(seed)`` for the
window's samples, ``default_rng(seed + 1000 + epoch)`` for chunk and
offsets), so for one seed and epoch the window and the draws match it.
The refresh thread only decodes; every upload is made on the main thread.
Single-process, packed-wire samples (data/pack.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch

from .device_cache import gather
from .loader import to_device


class EchoCacheLoader:
    """PrefetchLoader-shaped iterator (set_epoch / __iter__ / __len__)
    yielding batches gathered from a rotating window of augmented samples
    resident on ``device``."""

    def __init__(self, dataset, batch_size: int, window: int = 1024,
                 chunk: int = 64, seed: int = 0, log=None,
                 refresh_queue_depth: int = 2, device="cuda"):
        if getattr(dataset, "cache", None):
            raise ValueError("EchoCacheLoader needs an uncached dataset: "
                             "a sample cache would freeze the augmentation "
                             "this loader exists to keep fresh")
        n = len(dataset)
        window = min(window, n)
        chunk = min(chunk, window)
        if batch_size > chunk:
            raise ValueError(f"batch_size {batch_size} exceeds chunk size "
                             f"{chunk}: a batch gathers within one chunk")
        self.dataset = dataset
        self.batch_size = batch_size
        self.chunk = chunk
        self.n_chunks = max(1, window // chunk)
        self.window = self.n_chunks * chunk
        self.seed = seed
        self.epoch = 0
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._consumed = 0            # samples trained on
        self._refreshed = 0           # samples re-decoded into the window

        # a random first window, not the dataset's head (routes are stored
        # contiguously; a head window would be one route's frames)
        self._perm: List[int] = list(self._rng.permutation(n))
        self._perm_pos = 0
        self.chunks: List[Dict[str, torch.Tensor]] = []
        for j in range(self.n_chunks):
            self.chunks.append(self._upload(self._decode_chunk()))
            if log:
                log(f"echo-cache fill {j + 1}/{self.n_chunks} chunks")
        if log:
            total = sum(v.numel() * v.element_size()
                        for c in self.chunks for v in c.values())
            log(f"echo-cache resident: {self.window} samples in "
                f"{self.n_chunks} chunks, {total / 1e6:.0f} MB")

        self._fresh: "queue.Queue" = queue.Queue(maxsize=refresh_queue_depth)
        self._stop = threading.Event()
        self._rr = 0  # next chunk slot to replace, round-robin
        self._thread = threading.Thread(target=self._refresh_loop,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- decoding
    def _next_index(self) -> int:
        if self._perm_pos >= len(self._perm):
            self._perm = list(self._rng.permutation(len(self.dataset)))
            self._perm_pos = 0
        i = self._perm[self._perm_pos]
        self._perm_pos += 1
        return i

    def _decode_chunk(self) -> Dict[str, np.ndarray]:
        rows = [self.dataset[self._next_index()] for _ in range(self.chunk)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def _upload(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: to_device(v, self.device) for k, v in host.items()}

    def _refresh_loop(self) -> None:
        while not self._stop.is_set():
            host = self._decode_chunk()
            while not self._stop.is_set():
                try:
                    self._fresh.put(host, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def _maybe_swap(self) -> None:
        try:
            host = self._fresh.get_nowait()
        except queue.Empty:
            return
        self.chunks[self._rr] = self._upload(host)
        self._rr = (self._rr + 1) % self.n_chunks
        self._refreshed += self.chunk

    # -------------------------------------------------------------- iterator
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        # nominal epoch: one dataset's worth of samples, so LR schedules
        # and per-epoch logging line up with the other loaders
        return len(self.dataset) // self.batch_size

    def _draws(self):
        """This epoch's (chunk, offsets) draws, in order."""
        rng = np.random.default_rng(self.seed + 1000 + self.epoch)
        for _ in range(len(self)):
            j = int(rng.integers(self.n_chunks))
            yield j, rng.choice(self.chunk, self.batch_size, replace=False)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        draws = list(self._draws())
        offsets = to_device(np.stack([o for _, o in draws]), self.device) \
            if draws else None                 # one copy per epoch
        for step, (j, _) in enumerate(draws):
            self._maybe_swap()
            self._consumed += self.batch_size
            yield gather(self.chunks[j], offsets[step])

    # ------------------------------------------------------------- lifecycle
    @property
    def echo_factor(self) -> float:
        """Average number of times a window sample is consumed before its
        slot is re-decoded (lower is fresher; 1.0 matches a plain
        loader)."""
        return self._consumed / max(self._refreshed, self.window)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def __del__(self):  # best effort; close() is the real API
        try:
            self._stop.set()
        except Exception:
            pass
