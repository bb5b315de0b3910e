"""``DataLoader``: the port of ``paddle_tpu/io/dataloader.py``.

Batches come in the batch sampler's order, collated by ``collate_fn``
(``default_collate_fn`` stacks samples into CPU tensors; moving them to the
card is the step's business, as ``jit.TrainStep`` does).

- ``num_workers=0`` collates in the calling process.
- ``num_workers > 0`` forks worker processes, as the reference does (the
  dataset and ``collate_fn`` need not be importable; workers touch no CUDA
  state, only the dataset and the CPU). Worker ``i`` gets every
  ``num_workers``-th batch of indices, with up to ``prefetch_factor``
  batches a worker in flight; ``get_worker_info()`` inside a worker says
  which one it is, and it seeds numpy's stream and the port's default
  generator with ``seed + id`` (``seed`` drawn from the port's default
  generator), as the reference seeds numpy (``:65-69``), then calls
  ``worker_init_fn(id)`` when one is given (the reference takes the
  argument and never calls it). A worker's
  exception is raised in the parent with the worker's traceback; a worker
  that dies raises there too.
- Transport (reference ``:70-95``): with ``use_shared_memory`` each worker
  pickles its batch into its own shared-memory ring (``native/shm_ring.py``,
  built from ``csrc/host/shm_ring.cc`` at first use; a build that fails
  raises) and its queue carries only a control message; a payload larger
  than a ring slot (8 MB less 8 bytes) goes through the queue, the
  reference's rule. ``ring_pushes`` and ``queue_payloads`` count the two, so
  a run can show which transport carried its batches.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import traceback

import numpy as np
import torch

from ..framework import random as random_mod
from .dataset import BatchSampler, IterableDataset

__all__ = ["DataLoader", "get_worker_info", "default_collate_fn"]

_SHM_SENTINEL = "__shm__"
# how long the parent waits for a batch before it checks its workers
_POLL_S = 1.0


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_info = None


def get_worker_info():
    """Inside a worker process: its ``WorkerInfo`` (id, num_workers,
    dataset, seed); None in the main process."""
    return _worker_info


def default_collate_fn(batch):
    """Stack a list of samples: tensors with ``torch.stack``, numpy arrays
    and numbers into CPU tensors (through ``np.stack``/``np.asarray``, so
    the dtypes are numpy's), lists, tuples and dicts field by field."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    return batch


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, seed, ring_name, worker_init_fn):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, dataset, seed)
    # one thread: a forked child must not start the parent's thread pools
    torch.set_num_threads(1)
    np.random.seed((seed + worker_id) % (2 ** 31))
    random_mod.fresh_default_generator(seed + worker_id)
    ring = None
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if ring_name is not None:
            from ..native.shm_ring import ShmRing
            ring = ShmRing(ring_name, owner=False)
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        data_queue.put((-1, None, traceback.format_exc()))
        return
    while True:
        task = index_queue.get()
        if task is None:
            break
        batch_id, indices = task
        try:
            data = collate_fn([dataset[i] for i in indices])
            if ring is not None:
                payload = pickle.dumps(data, protocol=5)
                if len(payload) <= ring.payload_capacity and \
                        ring.push(payload):
                    data_queue.put((batch_id, (_SHM_SENTINEL, worker_id),
                                    None))
                    continue
            data_queue.put((batch_id, data, None))
        except Exception:  # noqa: BLE001 - reported to the parent
            data_queue.put((batch_id, None, traceback.format_exc()))
    if ring is not None:
        ring.free()


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_size = batch_size
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size
        # batches that came through a shared-memory ring, and through the
        # workers' queue (a payload larger than a ring slot, or no ring)
        self.ring_pushes = 0
        self.queue_payloads = 0

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_single()
        return self._iter_multiprocess()

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if self.batch_size is not None and len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch:
            yield self.collate_fn(batch)

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _next_message(self, data_queue, workers):
        """The next (batch id, data, error) from the workers; raises when a
        worker died or ``timeout`` passed without a batch."""
        waited = 0.0
        while True:
            try:
                return data_queue.get(timeout=_POLL_S)
            except queue_mod.Empty:
                waited += _POLL_S
                dead = [w.pid for w in workers if not w.is_alive()]
                if dead:
                    raise RuntimeError(f"DataLoader worker(s) {dead} exited "
                                       f"unexpectedly") from None
                if self.timeout and waited >= self.timeout:
                    raise TimeoutError(f"DataLoader timed out after "
                                       f"{self.timeout} s") from None

    def _iter_multiprocess(self):
        ctx = mp.get_context("fork")
        seed = int(torch.randint(
            0, 2 ** 31 - 1, (1,),
            generator=random_mod.default_generator().for_device("cpu")))
        rings, workers, index_queues = [], [], []
        data_queue = ctx.Queue()
        try:
            for wid in range(self.num_workers):
                ring_name = None
                if self.use_shared_memory:
                    from ..native.shm_ring import ShmRing
                    ring_name = f"/ptt_dl_{os.getpid()}_{id(self)}_{wid}"
                    rings.append(ShmRing(ring_name, owner=True))
                iq = ctx.Queue()
                w = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, iq, data_queue, self.collate_fn, wid,
                          self.num_workers, seed, ring_name,
                          self.worker_init_fn),
                    daemon=True)
                w.start()
                workers.append(w)
                index_queues.append(iq)
            yield from self._run(data_queue, index_queues, workers, rings)
        finally:
            for iq in index_queues:
                iq.put(None)
            for r in rings:
                r.close()
            for w in workers:
                w.join(timeout=1)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1)
            for r in rings:
                r.free()

    def _run(self, data_queue, index_queues, workers, rings):
        sampler_iter = iter(self.batch_sampler)
        sent = 0

        def send_next():
            nonlocal sent
            indices = next(sampler_iter, None)
            if indices is not None:
                index_queues[sent % self.num_workers].put((sent, indices))
                sent += 1

        for _ in range(self.prefetch_factor * self.num_workers):
            send_next()
        reorder, next_yield, total = {}, 0, len(self.batch_sampler)
        while next_yield < total:
            if next_yield in reorder:
                yield reorder.pop(next_yield)
                next_yield += 1
                continue
            bid, data, err = self._next_message(data_queue, workers)
            if err is not None:
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            if isinstance(data, tuple) and len(data) == 2 and \
                    data[0] == _SHM_SENTINEL:
                # pop now, in the order of the control messages: a worker's
                # ring is FIFO, so popping in yield order would pair
                # payloads with the wrong batch ids
                data = pickle.loads(rings[data[1]].pop(timeout_ms=60000))
                self.ring_pushes += 1
            else:
                self.queue_payloads += 1
            send_next()
            reorder[bid] = data
