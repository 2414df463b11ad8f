"""Threaded batch loader, the counterpart of `lara_tpu/data/loader.py`
(in place of torch DataLoader's worker processes, train_lightning.py:35-45),
and `device_prefetch`, the one-device counterpart of
`lara_tpu/parallel/mesh.py:device_prefetch`.

Worker threads decode whole batches (NumPy releases the GIL in its array
work) into a bounded queue that the consumer drains in batch order; the
epoch's shuffle is `np.random.default_rng((seed, epoch))`, as in the JAX
package, so both packages visit the scenes in one order.

Under data parallelism every rank draws the same order of global batches
and collates only its own slice of each (`parallel/mesh.py:rank_slice`),
as the JAX package shards a global batch over dp; a dataset whose samples
are random (the training split's views and backgrounds) draws for the
other ranks' samples too (`skip`), so that with one worker thread each
rank's samples are bit for bit those of one process. Under tensor
parallelism the trainer passes the dp index and the dp size as `rank` and
`world_size`: the tp ranks of one dp index collate the same scenes, and
the trainer gives them the first one's draws (`parallel/tp.py:broadcast_batch`).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from lara_tpu_torch.parallel.mesh import check_divides, rank_slice


def collate(samples: list) -> dict:
    """Stack a list of per-scene dicts into batch arrays; `meta` entries are
    collected into a list (the reference keeps them as Python values). No
    samples make `{"meta": []}`."""
    if not samples:
        return {"meta": []}
    out = {}
    for k in samples[0]:
        if k == "meta":
            out["meta"] = [s["meta"] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class DataLoader:
    """Global batches of `batch_size` scenes (the last, partial batch is
    dropped unless `drop_last` is False), collated by `num_workers` threads
    (0: in the consumer) at most `prefetch` batches ahead. With
    `world_size` > 1 each batch is rank `rank`'s contiguous slice of the
    global batch (`batch_size` must divide by `world_size`); `len()`, the
    order and `drop_last` stay the global batch's. A last partial batch
    that does not divide goes to rank 0 alone (an empty batch elsewhere),
    as evaluation takes such a batch on one device."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, rank: int = 0, world_size: int = 1):
        check_divides(batch_size, world_size, "batch_size")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rank, self.world_size = rank, world_size
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size: (b + 1) * self.batch_size]

    def _load(self, ids) -> dict:
        """This rank's samples of the global batch `ids`, collated. The
        others' are passed over in their order with the dataset's `skip`
        (where it has one), which draws their augmentation, so each sample
        is what one process would load."""
        if len(ids) % self.world_size:
            mine = range(len(ids)) if self.rank == 0 else range(0)
        else:
            mine = range(len(ids))[rank_slice(len(ids), self.rank, self.world_size)]
        skip = getattr(self.dataset, "skip", None)
        samples = []
        for k, i in enumerate(ids):
            if k in mine:
                samples.append(self.dataset[int(i)])
            elif skip is not None:
                skip(int(i))
        return collate(samples)

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers == 0:
            for ids in self._batch_indices():
                yield self._load(ids)
            return

        batches = list(self._batch_indices())
        out_q: "queue.Queue[tuple[int, Optional[dict], Optional[BaseException]]]" = (
            queue.Queue(maxsize=self.prefetch))
        lock = threading.Lock()
        cursor = [0]
        stop_ev = threading.Event()

        def put_with_backpressure(item) -> bool:
            # a blocking put() would leave a worker stuck for ever when the
            # consumer stops early (every epoch under limit_train_batches <
            # 1): poll the stop event instead
            while not stop_ev.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop_ev.is_set():
                with lock:
                    i = cursor[0]
                    if i >= len(batches):
                        return
                    cursor[0] += 1
                try:
                    batch = self._load(batches[i])
                except Exception as e:  # raised again in the consumer
                    put_with_backpressure((i, None, e))
                    return
                if not put_with_backpressure((i, batch, None)):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        pending: dict = {}
        next_i = received = 0
        try:
            while received < len(batches):
                i, batch, err = out_q.get()
                if err is not None:
                    raise err
                received += 1
                pending[i] = batch
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        finally:
            stop_ev.set()
            with lock:
                cursor[0] = len(batches)
            # drain, so that a worker blocked in put() returns and its
            # prefetched batch is released
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass


def to_device(batch: dict, device) -> dict:
    """Host batch (NumPy arrays, `meta`) → tensors on `device`. For a CUDA
    device each array is copied into pinned memory and then to the device
    without blocking the host; `meta` passes through."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "meta":
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(iterator, device):
    """Wrap a host batch iterator: each batch is put on `device` (`to_device`)
    one batch ahead of the one yielded, so its copy overlaps the step that
    runs on the batch before it."""
    batch = next(iterator, None)
    ahead = None if batch is None else to_device(batch, device)
    while ahead is not None:
        current = ahead
        batch = next(iterator, None)
        ahead = None if batch is None else to_device(batch, device)
        yield current
