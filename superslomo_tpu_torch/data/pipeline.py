"""Batching loader and device feed.

``Loader`` is a copy of the JAX package's: a thread pool decodes and
transforms samples (the PNG unfilter and zlib release the GIL), two batches in
flight, each item drawing from its own generator. ``prefetch_to_device``
takes the place of the JAX package's ``device_put`` prefetch: a producer
thread copies each batch into pinned host memory and on to the card with
``non_blocking`` copies on a side stream, so the copy of batch k+1 overlaps
step k.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch


def _collate(samples: Sequence[tuple]) -> tuple:
    """Stack a list of per-sample tuples into batched numpy arrays (ints
    collate to an int array)."""
    out = []
    for parts in zip(*samples):
        if isinstance(parts[0], np.ndarray):
            out.append(np.stack(parts))
        else:
            out.append(np.asarray(parts))
    return tuple(out)


class Loader:
    """Iterable over shuffled, collated batches of a reader.

    Each epoch shuffles with ``default_rng([seed, epoch])``, and each item
    draws from its own generator ``default_rng([seed, epoch, index])``, so the
    batches are the same bit for bit for any ``num_threads`` (NumPy Generators
    are not thread-safe). Each ``iter`` is the next epoch."""

    def __init__(self, reader, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_threads: int = 4, seed: int = 0):
        self.reader = reader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.reader)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, idx: int, epoch: int):
        return self.reader.__getitem__(idx, rng=np.random.default_rng([self.seed, epoch, idx]))

    def __iter__(self) -> Iterator[tuple]:
        n = len(self.reader)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        epoch = self._epoch
        self._epoch += 1

        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_threads == 1:
            for b in batches:
                yield _collate([self._fetch(int(i), epoch) for i in b])
            return

        with ThreadPoolExecutor(self.num_threads) as pool:
            # two batches in flight
            pending = []
            it = iter(batches)

            def submit(b):
                return [pool.submit(self._fetch, int(i), epoch) for i in b]

            for _ in range(2):
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
            while pending:
                futs = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append(submit(b))
                yield _collate([f.result() for f in futs])


class _Staging:
    """The pinned host buffers of one batch in flight and the event of their
    copy to the card: the buffers are refilled only after that copy completed."""

    def __init__(self):
        self.buffers: list = []
        self.copied = None  # torch.cuda.Event of the last copy out of the buffers

    def fill(self, batch) -> list:
        if self.copied is not None:
            self.copied.synchronize()
        arrays = [np.asarray(x) for x in batch]
        if [(b.shape, b.dtype) for b in self.buffers] != [(a.shape, a.dtype) for a in arrays]:
            self.buffers = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True).numpy()
                            for a in arrays]
        for buf, a in zip(self.buffers, arrays):
            buf[...] = a
        return [torch.from_numpy(b) for b in self.buffers]


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator[tuple]:
    """Yield the batches of ``iterator`` (tuples of numpy arrays) as tuples
    of tensors on ``device``, up to ``size`` batches ahead, from a producer
    thread.

    On a CUDA device each batch goes through pinned host buffers (a ring of
    ``size + 2``; each refilled only after its last copy's event completed)
    and is copied with ``non_blocking=True`` on a side stream. The consumer's
    stream waits on the copy's event before it uses the tensors, and each
    tensor is recorded on that stream, so the caching allocator does not hand
    its memory to a later copy while the step still reads it. On the CPU the
    batches come as tensors sharing the arrays' memory. An exception in the
    producer is raised in the consumer; closing the generator stops the
    producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def producer():
        last = end
        try:
            if cuda:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
                ring = [_Staging() for _ in range(size + 2)]
            for k, batch in enumerate(iterator):
                if cuda:
                    staging = ring[k % len(ring)]
                    host = staging.fill(batch)
                    with torch.cuda.stream(stream):
                        item = tuple(h.to(device, non_blocking=True) for h in host)
                        staging.copied = torch.cuda.Event()
                        staging.copied.record(stream)
                    item = (item, staging.copied)
                else:
                    item = (tuple(torch.from_numpy(np.asarray(x)) for x in batch), None)
                q.put(item)
                if stop.is_set():
                    break
        except Exception as exc:  # handed to the consumer, which raises it
            last = exc
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            q.put(last)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            tensors, copied = item
            if copied is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copied)
                for t in tensors:
                    t.record_stream(current)
            yield tensors
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
