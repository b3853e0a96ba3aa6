"""Host-to-device loader of a map-style dataset; counterpart of
lemevit_tpu/data/loader.py.

  Loader(dataset, batch_size, shuffle, drop_last, num_threads, seed, rank,
         world_size, collate_fn, device, num_procs, dataset_spec)
  create_loader(dataset, batch_size, is_training, **kwargs)
      training: shuffled by RandomState(seed + epoch) (set_epoch), whole
      batches only; evaluation: in order, the last batch may be short

``num_threads`` producer threads build batches bi = start + t, start + t +
num_threads, ... into a queue each, and the consumer takes from the queues
in turn, so batches come out in sequence. ``num_procs`` > 0 puts spawned
worker processes in the threads' place, each of which builds the dataset
from ``dataset_spec`` (data/spawn.py); they are never forked, because a
forked child of a process that has initialised CUDA cannot use it. ``rank`` /
``world_size`` stride the indices, one shard per process.

Each sample draws from its own generators, transforms.sample_rng(seed,
epoch, index), so 1 or 4 threads, worker processes and ``iter_batches
(start)`` (resume mid-epoch without building the skipped batches) all give
the same batches.

``collate_fn`` turns a list of samples into a dict of CPU tensors; the
default, ``collate_labels``, takes (uint8 HWC image, int label) samples;
segmentation passes its own. Batches cross to the device as uint8 NHWC
(normalised there): the producers pin them, and on a CUDA device a
DevicePrefetcher copies them on a side stream, DEVICE_PREFETCH ahead.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from lemevit_tpu_torch.data.datasets import load_sample

PREFETCH = 2  # batches each producer thread or worker builds ahead
DEVICE_PREFETCH = 2  # batches copied to the card ahead of the consumer
POLL_S = 0.1  # how often a blocked producer looks for a stop

Collate = Callable[[Sequence], Dict[str, torch.Tensor]]


def collate_labels(samples) -> Dict[str, torch.Tensor]:
    """{"image": uint8 (B, H, W, 3), "label": int64 (B,)}."""
    return {"image": torch.from_numpy(np.stack(
                [np.asarray(im, dtype=np.uint8) for im, _ in samples])),
            "label": torch.tensor([lab for _, lab in samples],
                                  dtype=torch.int64)}


class _Failure:
    """An exception raised while building a batch, handed to the consumer
    and raised there."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _offer(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first; whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=POLL_S)
            return True
        except queue.Full:
            pass
    return False


class Loader:
    """Batches of a dataset; see the module docstring."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 4,
                 seed: int = 0, rank: int = 0, world_size: int = 1,
                 collate_fn: Collate = collate_labels,
                 device: Optional[Any] = None, num_procs: int = 0,
                 dataset_spec=None):
        if num_procs > 0 and dataset_spec is None:
            raise ValueError("worker processes build their dataset from a "
                             "dataset_spec (data/spawn.py)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.collate_fn = collate_fn
        self.device = torch.device(device or "cpu")
        self.num_procs = num_procs
        self.dataset_spec = dataset_spec
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.world_size
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.rank::self.world_size]

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0
                     ) -> Iterator[Dict[str, torch.Tensor]]:
        """This epoch's batches from batch index ``start`` on, on
        ``device``."""
        host = (self._iter_procs(start) if self.num_procs > 0
                else self._iter_threads(start))
        if self.device.type != "cuda":
            yield from host
            return
        prefetch = DevicePrefetcher(
            host, lambda v: v.to(self.device, non_blocking=True),
            depth=DEVICE_PREFETCH, stream=torch.cuda.Stream(self.device))
        try:
            yield from prefetch
        finally:
            prefetch.close()

    def _pinned(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return batch
        return {k: v.pin_memory() for k, v in batch.items()}

    def _iter_threads(self, start: int) -> Iterator[Dict[str, torch.Tensor]]:
        idx = self._indices()
        nb, bs = len(self), self.batch_size
        n_threads = max(1, min(self.num_threads, nb - start))
        queues = [queue.Queue(maxsize=PREFETCH) for _ in range(n_threads)]
        stop = threading.Event()

        def produce(t: int) -> None:
            try:
                for bi in range(start + t, nb, n_threads):
                    samples = [load_sample(self.dataset, int(i), self.seed,
                                           self.epoch)
                               for i in idx[bi * bs:(bi + 1) * bs]]
                    if not _offer(queues[t], self._pinned(
                            self.collate_fn(samples)), stop):
                        return
            except Exception as e:  # raised at the consumer
                _offer(queues[t], _Failure(e), stop)

        threads = [threading.Thread(target=produce, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        try:
            yield from _in_sequence(lambda t: queues[t].get(), n_threads,
                                    start, nb)
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=10)

    def _iter_procs(self, start: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Spawned workers in the threads' place, each with its queue."""
        idx = self._indices()
        nb = len(self)
        n_procs = max(1, min(self.num_procs, nb - start))
        ctx = mp.get_context("spawn")
        queues = [ctx.Queue(maxsize=PREFETCH) for _ in range(n_procs)]
        procs = [ctx.Process(
            target=_spawn_worker,
            args=(self.dataset_spec, idx, start + w, nb, n_procs,
                  self.batch_size, self.seed, self.epoch, self.collate_fn,
                  queues[w]), daemon=True) for w in range(n_procs)]
        for p in procs:
            p.start()

        def take(w: int):
            while True:
                # a worker flushes its queue before it exits, so a get that
                # waited after the exit finds whatever it sent
                exited = procs[w].exitcode is not None
                try:
                    item = queues[w].get(timeout=1.0)
                except queue.Empty:
                    if exited:
                        raise RuntimeError(
                            f"loader worker {w} exited ({procs[w].exitcode})"
                            " before its next batch") from None
                    continue
                if isinstance(item, _Failure):
                    return item
                return self._pinned({k: torch.from_numpy(v)
                                     for k, v in item.items()})

        try:
            yield from _in_sequence(take, n_procs, start, nb)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


def _in_sequence(take: Callable, n: int, start: int, nb: int):
    """Batches start, ..., nb - 1 of ``n`` producers, producer w building
    start + w, start + w + n, ...: each taken from its producer in turn
    (``take(w)``); a _Failure is raised."""
    for bi in range(start, nb):
        item = take((bi - start) % n)
        if isinstance(item, _Failure):
            raise item.exc
        yield item


def _spawn_worker(spec, idx, first, nb, stride, batch_size, seed, epoch,
                  collate_fn, out_q) -> None:
    """A worker process: builds the dataset from its spec (numpy, PIL and
    CPU torch; never CUDA) and sends batches first, first + stride, ... as
    numpy arrays, or a _Failure that carries the traceback."""
    try:
        dataset = spec.build()
        for bi in range(first, nb, stride):
            samples = [load_sample(dataset, int(i), seed, epoch)
                       for i in idx[bi * batch_size:(bi + 1) * batch_size]]
            out_q.put({k: v.numpy()
                       for k, v in collate_fn(samples).items()})
    except Exception:  # raised at the consumer
        out_q.put(_Failure(RuntimeError(
            f"a loader worker failed:\n{traceback.format_exc()}")))


class DevicePrefetcher:
    """A background thread pulls batches (dicts) from ``raw_iter`` and
    applies ``put`` to each value, keeping up to ``depth`` batches ready.
    With a CUDA ``stream`` it copies on that stream: the consumer's stream
    waits for the copy, and each tensor is recorded as used there. A
    failure in ``raw_iter`` or ``put`` raises at the consumer; ``close()``
    retires the thread and closes ``raw_iter``."""

    def __init__(self, raw_iter, put: Callable, depth: int = 2,
                 stream: Optional["torch.cuda.Stream"] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = object()
        self._ended = False
        self._stream = stream

        def worker():
            try:
                for batch in raw_iter:
                    if self._stop.is_set() or not _offer(
                            self._q, self._copy(batch, put), self._stop):
                        return
                _offer(self._q, self._done, self._stop)
            except Exception as exc:  # raised in __next__
                _offer(self._q, _Failure(exc), self._stop)
            finally:
                close = getattr(raw_iter, "close", None)
                if close is not None:
                    close()

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def _copy(self, batch: Dict[str, Any], put: Callable):
        if self._stream is None:
            return {k: put(v) for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: put(v) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._ended = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._ended = True
            raise item.exc
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(consumer)
        return batch

    def close(self) -> None:
        """Stop the thread (it closes ``raw_iter``) and drop the batches it
        built, so that an unconsumed prefetcher holds no device memory."""
        self._stop.set()
        self._ended = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=10)


def create_loader(dataset, batch_size: int, is_training: bool = False,
                  **kwargs) -> Loader:
    """A Loader that shuffles and drops the ragged tail when training, and
    keeps the dataset's order and every sample when not."""
    return Loader(dataset, batch_size, shuffle=is_training,
                  drop_last=is_training, **kwargs)
