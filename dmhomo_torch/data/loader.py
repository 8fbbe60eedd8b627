"""Batching of dict samples: the seeded shuffling, prefetching ``DataLoader``
with per-host sharding and worker threads or processes (the JAX package's
``data/loader.py``), plain in-order batches, tail padding and ``cycle``."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

_WORKER_DATASET = None  # the dataset, in a worker process


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(idx: int):
    return _WORKER_DATASET[idx]


def collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    if isinstance(first, (str, bytes)):
        return list(items)
    return np.stack([np.asarray(it) for it in items])


def iterate_batches(dataset, batch_size: int) -> Iterator[dict]:
    """Batches of ``batch_size`` samples in dataset order; the last may be short."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield collate([dataset[i] for i in range(start, stop)])


def pad_batch(batch: dict, batch_size: int):
    """Pad a short tail batch to ``batch_size`` by repeating its last element
    (arrays along axis 0, lists extended).  Returns (padded_batch, n_valid)."""
    first = next(iter(batch.values()))
    n = len(first) if isinstance(first, list) else first.shape[0]
    if n > batch_size:
        raise ValueError(f"batch of {n} exceeds batch_size {batch_size}")
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = v + [v[-1]] * pad
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
    return out, n


def pin(batch):
    """A collated batch with every numpy array as a torch tensor in pinned
    (page-locked) host memory, from which a copy to the card can run
    asynchronously (``non_blocking=True``); other values as they are."""
    if isinstance(batch, dict):
        return {k: pin(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).pin_memory()
    return batch


class DataLoader:
    """Batches of ``batch_size`` samples of this shard, as the JAX package's
    loader makes them.  With ``shuffle`` the order of epoch e (counted from 1)
    is ``np.random.default_rng(seed + e)``'s permutation of the whole index
    space, of which shard ``shard_index`` of ``num_shards`` takes every
    ``num_shards``-th index from its own.

    ``num_workers`` > 0 fetches each batch's samples in parallel: threads, or
    with ``use_processes`` processes forked from this one, each holding a
    copy of the dataset.  A forked child must touch no CUDA (the card's
    state does not survive a fork): the children only index the dataset,
    which reads files and computes with numpy; collating and pinning run in
    this process.  A dataset that draws from a shared generator (the crop
    starts of ``HEMTrainDataset``) takes its draws in the order the workers
    ask for them.

    ``prefetch`` > 0 builds up to that many batches ahead on a background
    thread; an error raised while fetching reaches the consumer when it asks
    for the batch it belongs to.  ``pin_memory`` hands over each batch's
    arrays as tensors in pinned host memory, for a consumer on the card that
    copies them asynchronously; numpy arrays otherwise.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, prefetch: int = 2, num_workers: int = 0,
                 use_processes: bool = False, pin_memory: bool = False):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.use_processes = use_processes
        self.pin_memory = pin_memory
        self.epoch = 0
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            if self.use_processes:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context("fork"),
                    initializer=_worker_init, initargs=(self.dataset,))
            else:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_workers)
        return self._pool

    def close(self) -> None:
        """Stop the workers (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator:
        idx = self._indices()
        if self.num_workers > 0:
            pool = self._get_pool()
            fetch = _worker_get if self.use_processes else self.dataset.__getitem__
        for b in range(len(self)):
            sel = [int(i) for i in idx[b * self.batch_size:(b + 1) * self.batch_size]]
            items = (list(pool.map(fetch, sel)) if self.num_workers > 0
                     else [self.dataset[i] for i in sel])
            batch = collate(items)
            yield pin(batch) if self.pin_memory else batch

    def __iter__(self) -> Iterator:
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                for batch in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            pass
                    if stop.is_set():
                        return
                q.put(done)
            except BaseException as e:  # handed to the consumer, raised there
                q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the consumer stopped early or the epoch ended: let the producer
            # finish its batch in flight and leave
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()


def cycle(loader) -> Iterator:
    """Endless batch stream (the reference's ``cycle``)."""
    while True:
        yield from loader
