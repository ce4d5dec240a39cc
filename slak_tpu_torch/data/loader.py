"""The batch loader: port of ``slak_tpu/data/loader.py`` on
``torch.utils.data``.

Index order (:class:`ShardedBatchSampler`, ``slak_tpu``'s ``_indices``):
the epoch's permutation from ``np.random.default_rng(seed + epoch)`` when
shuffling, DistributedSampler-style rank slices with wrap-around padding,
batches of ``batch_size`` with or without the ragged last one. ``pad=False``
leaves the padding out, so that the ranks together visit each item exactly
once (the data-parallel eval split; the ranks' counts may then differ by
one).

Workers (``mode``):
  * "process": a ``torch.utils.data.DataLoader`` with ``num_workers``
    spawned worker processes, new each epoch, the batches pinned;
  * "thread": as many threads in this process (PIL and the native
    library release the interpreter lock), the batches pinned.
Either way batch b is built by worker b mod num_workers, in order, and
worker w draws its host randomness from a stream seeded with
``(seed + epoch) * 9973 + w`` (``slak_tpu``'s process workers' seed): the
bytes of an epoch do not depend on the mode or on timing.

Failure policy (``slak_tpu``'s): a worker that raises fails the
iteration with its error, a worker process that dies fails it with the
DataLoader's watchdog error; nothing is respawned, and recovery is the
train CLI's auto-resume.

:func:`device_prefetch` copies the next batch to the card on a side
stream while the current step runs.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

from slak_tpu_torch.data.host_rng import seeded

LOADER_MODES = ("thread", "process")


def worker_seed(seed: int, epoch: int, worker_id: int) -> int:
    return (seed + epoch) * 9973 + worker_id


class ShardedBatchSampler(torch.utils.data.Sampler):
    """Lists of dataset indices, one a batch, in ``slak_tpu``'s
    ``BatchLoader`` order for (seed, epoch, rank, world_size)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1, pad: bool = True):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self.seed, self.rank, self.world_size = seed, rank, world_size
        self.pad = pad
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.world_size > 1:
            if self.pad:
                per = -(-self.n // self.world_size)
                idx = np.concatenate([idx,
                                      idx[:per * self.world_size - self.n]])
            idx = idx[self.rank::self.world_size]
        return idx

    def __len__(self):
        n = len(self.indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        idx = self.indices()
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size].tolist()


def collate(items) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(image (H, W, C), label)] -> float32 NHWC and int64 tensors."""
    xs = np.stack([np.asarray(x, np.float32) for x, _ in items])
    return torch.from_numpy(xs), torch.as_tensor([y for _, y in items],
                                                 dtype=torch.int64)


def _seed_process_worker(base: int, worker_id: int):
    """DataLoader worker_init_fn: seed the worker's host streams."""
    s = base + worker_id
    random.seed(s)
    np.random.seed(s % 2 ** 32)
    torch.manual_seed(s)


class BatchLoader:
    """Iterate (images NHWC float32, labels int64) CPU tensors of one
    epoch; ``set_epoch`` before each."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, seed: int = 0,
                 rank: int = 0, world_size: int = 1,
                 prefetch_batches: int = 4, mode: str = "thread",
                 pin_memory: bool = False, pad: bool = True):
        if mode not in LOADER_MODES:
            raise ValueError(f"loader mode {mode!r}: one of "
                             f"{'/'.join(LOADER_MODES)}")
        self.ds = dataset
        self.batch_size = batch_size
        self.sampler = ShardedBatchSampler(len(dataset), batch_size, shuffle,
                                           drop_last, seed, rank, world_size,
                                           pad)
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = max(prefetch_batches, 1)
        self.mode = mode
        self.pin_memory = pin_memory

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    @property
    def epoch(self) -> int:
        return self.sampler.epoch

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        if self.mode == "process":
            return iter(self._dataloader())
        return self._iter_thread()

    def _dataloader(self) -> torch.utils.data.DataLoader:
        import functools
        import multiprocessing as mp
        nw = min(self.num_workers, max(len(self), 1))
        return torch.utils.data.DataLoader(
            self.ds, batch_sampler=self.sampler, num_workers=nw,
            collate_fn=collate, pin_memory=self.pin_memory,
            worker_init_fn=functools.partial(
                _seed_process_worker, worker_seed(self.seed, self.epoch, 0)),
            multiprocessing_context=mp.get_context("spawn"),
            prefetch_factor=max(self.prefetch // nw, 2),
            persistent_workers=False)

    def _iter_thread(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        batches = list(self.sampler)
        nw = min(self.num_workers, max(len(batches), 1))
        # one bounded queue a worker: worker w fills batches w, w + nw, ...
        queues = [queue.Queue(maxsize=max(self.prefetch // nw, 1))
                  for _ in range(nw)]
        stop = threading.Event()

        def work(w):
            try:
                with seeded(worker_seed(self.seed, self.epoch, w)):
                    for b in range(w, len(batches), nw):
                        if stop.is_set():
                            return
                        out = collate([self.ds[j] for j in batches[b]])
                        if self.pin_memory:
                            out = tuple(t.pin_memory() for t in out)
                        queues[w].put(("ok", out))
            except Exception as e:              # reported to the consumer
                queues[w].put(("err", e))

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(nw)]
        for t in threads:
            t.start()
        try:
            for b in range(len(batches)):
                kind, item = queues[b % nw].get()
                if kind == "err":
                    raise RuntimeError(
                        f"loader worker {b % nw} failed on batch {b}") \
                        from item
                yield item
        finally:
            stop.set()
            for q in queues:               # unblock a worker waiting on put
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            for t in threads:
                t.join(timeout=10)


def device_prefetch(it, device: torch.device):
    """Yield ``it``'s batches on ``device``. On CUDA the next batch's copy
    (non-blocking, from pinned memory) is issued on a side stream before
    the current batch is handed over, and the compute stream waits on the
    copy before it uses a batch."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in it:
            yield tuple(t.to(device) for t in batch)
        return
    side = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(side):
            return tuple(t.to(device, non_blocking=True) for t in batch)

    it = iter(it)
    try:
        nxt = put(next(it))
    except StopIteration:
        return
    while nxt is not None:
        cur = nxt
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(side)
        for t in cur:
            t.record_stream(compute)
        try:
            nxt = put(next(it))
        except StopIteration:
            nxt = None
        yield cur
