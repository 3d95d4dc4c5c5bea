"""Host-side batching + prefetch feeding the device.

Counterpart of ``esrganplus_tpu/data/loader.py`` (the reference's torch
``DataLoader`` role, ``codes/data/__init__.py:6-37``): worker threads
decode/crop on the host CPU, a bounded queue holds collated numpy batches, and
:class:`DeviceFeeder` overlaps the host→device copy with compute from a
background thread (pinned staging buffers, ``non_blocking`` copies on a side
stream).
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from esrganplus_tpu_torch.parallel import mesh


def collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)  # e.g. per-sample category labels
        else:
            out[key] = vals
    return out


class TrainLoader:
    """Infinite shuffled batch iterator with threaded workers.

    drop_last semantics (reference ``data/__init__.py:14``): only full batches
    are emitted. Batch ``k`` is a function of ``(seed, k)`` alone: epoch ``e``
    is a permutation drawn from ``(seed, e)``, and the crops and flips of
    batch ``k`` from ``(seed, k)``, and batches are handed out in the order
    of ``k`` whichever worker finished first. So the stream is the same for
    any number of workers, and ``start_batch=N`` begins it at batch N without
    producing the batches before it: a run resumed at step N sees what an
    uninterrupted run would. (The JAX package draws the whole stream from one
    sequential generator and restarts it on resume.)

    Several processes (``host_index`` of ``host_count``; by default this
    process's rank and the world size of ``parallel/mesh.py``) draw disjoint
    interleaved streams from the one seeded stream: host i takes the batches
    k ≡ i (mod host_count), so a global step consumes host_count ×
    batch_size distinct samples, and ``start_batch=N`` begins each host at
    its own N-th batch.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 seed: int = 0, queue_depth: int = 8, start_batch: int = 0,
                 host_index: Optional[int] = None, host_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.host_index = mesh.rank() if host_index is None else int(host_index)
        self.host_count = max(1, mesh.world_size() if host_count is None else int(host_count))
        if not 0 <= self.host_index < self.host_count:
            raise ValueError(f"host_index {self.host_index} of {self.host_count} hosts")
        # this host's N-th batch is batch k = N·host_count + host_index of the stream
        self._k0 = int(start_batch) * self.host_count + self.host_index
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        # batches handed to the workers and not yet yielded, those held back
        # for their turn included, stay within the queue's depth plus one in
        # the making per worker
        self._slots = threading.Semaphore(queue_depth + self.num_workers)
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    def _index_stream(self):
        """(k, sample indices of batch k) of this host's batches k from
        its ``start_batch``-th on, ``host_count`` apart."""
        n = len(self.dataset)
        # Repeat the shuffled epoch enough times that at least one full batch
        # exists even when the dataset is smaller than the batch (debug runs).
        reps = max(1, -(-self.batch_size // n))
        per_epoch = reps * n // self.batch_size
        k = self._k0
        while True:
            epoch = k // per_epoch
            rng = random.Random(f"{self.seed}/epoch/{epoch}")
            order = []
            for _ in range(reps):
                ep = list(range(n))
                rng.shuffle(ep)
                order.extend(ep)
            while k // per_epoch == epoch:
                i = (k % per_epoch) * self.batch_size
                yield k, order[i:i + self.batch_size]
                k += self.host_count

    def _worker(self, batches_q):
        while not self._stop.is_set():
            try:
                k, idxs = batches_q.get(timeout=0.2)
            except queue.Empty:
                continue
            rng = random.Random(f"{self.seed}/batch/{k}")
            try:
                batch = collate([self.dataset.sample(i, rng) for i in idxs])
            except Exception as e:  # raised on the consumer's thread at batch k
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((k, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _start(self):
        self._started = True
        self._idx_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)

        def feeder():
            for item in self._index_stream():
                while not self._slots.acquire(timeout=0.2):
                    if self._stop.is_set():
                        return
                while not self._stop.is_set():
                    try:
                        self._idx_q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._threads.append(threading.Thread(target=feeder, daemon=True))
        for _ in range(self.num_workers):
            self._threads.append(
                threading.Thread(target=self._worker, args=(self._idx_q,), daemon=True))
        for t in self._threads:
            t.start()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._started:
            self._start()
        # batches finish in any order across workers: hold the early ones
        # until their turn (the queue keeps draining, so no worker waits on
        # a full queue while the next batch is still being made; the feeder's
        # slots bound how many are held)
        early: Dict[int, Dict[str, np.ndarray]] = {}
        k = self._k0
        while True:
            while k not in early:
                done, batch = self._q.get()
                early[done] = batch
            batch = early.pop(k)
            self._slots.release()
            if isinstance(batch, Exception):
                raise batch
            yield batch
            k += self.host_count

    def stop(self):
        self._stop.set()
        # drain so workers blocked on a full queue can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=1.0)


class EvalLoader:
    """Sequential batch-1 iterator (reference val/test loader semantics)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]

    def __len__(self):
        return len(self.dataset)


def _as_feed_array(a) -> np.ndarray:
    """A batch entry as the device receives it: integer labels (SFT-GAN's
    category) as int64, everything else as float32."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return np.ascontiguousarray(a, dtype=np.int64)
    return np.ascontiguousarray(a, dtype=np.float32)


class DeviceFeeder:
    """Wraps a host batch iterator; a background thread keeps up to
    ``prefetch`` batches already on ``device``. Yields
    ``(tuple of tensors for keys, host batch)``: float32, and int64 for
    integer entries (SFT-GAN's category).

    On a CUDA device each array is staged in pinned memory and copied with
    ``non_blocking=True`` on a side stream; the consumer's stream waits on the
    copy's event, so the copy overlaps the previous step's kernels. On the
    CPU the arrays are wrapped as they are."""

    def __init__(self, host_iter, device, keys=("LR", "HR"), prefetch: int = 2):
        self._host = iter(host_iter)
        self._device = torch.device(device)
        self._keys = keys
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        cuda = self._device.type == "cuda"
        stream = torch.cuda.Stream(self._device) if cuda else None
        try:
            while not self._stop.is_set():
                batch = next(self._host)
                arrs = [torch.from_numpy(_as_feed_array(batch[k])) for k in self._keys]
                event = None
                if cuda:
                    with torch.cuda.stream(stream):
                        arrs = [a.pin_memory().to(self._device, non_blocking=True)
                                for a in arrs]
                        event = torch.cuda.Event()
                        event.record(stream)
                if not self._put((tuple(arrs), batch, event)):
                    return
        except StopIteration:
            self._put(None)
        except BaseException as e:  # surfaced on the consumer's thread
            self._put(e)

    def __iter__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            arrs, batch, event = item
            if event is not None:
                torch.cuda.current_stream(self._device).wait_event(event)
                for a in arrs:  # the side stream allocated them
                    a.record_stream(torch.cuda.current_stream(self._device))
            yield arrs, batch

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def create_dataloader(dataset, dataset_opt: Dict, seed: int = 0, start_batch: int = 0,
                      host_index: Optional[int] = None, host_count: Optional[int] = None):
    """Reference factory surface (``codes/data/__init__.py:6-19``); a train
    loader's ``batch_size`` is per process (:class:`TrainLoader`)."""
    if dataset_opt.get("phase") == "train":
        return TrainLoader(
            dataset,
            batch_size=dataset_opt.get("batch_size", 16),
            num_workers=dataset_opt.get("n_workers", 4),
            seed=seed,
            start_batch=start_batch,
            host_index=host_index,
            host_count=host_count,
        )
    return EvalLoader(dataset)
