"""Host-to-device loaders of a map-style dataset of (uint8 HWC image, int
label) samples; counterpart of lemevit_tpu/data/loader.py.

  create_loader(dataset, batch_size, device)   evaluation: in order, the
      last batch may be short
  Loader(dataset, batch_size, device, seed)    training: a permutation per
      epoch from seed + epoch (set_epoch), whole batches only, and
      iter_batches(start) to resume mid-epoch without building the skipped
      batches

Batches cross as uint8 NHWC (normalised on the device), from pinned host
memory without blocking the host. The training loader builds its batches in
one background thread, PREFETCH ahead of the consumer. Worker processes
are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

PREFETCH = 2  # batches the training loader's thread builds ahead


def _collate(dataset, indices) -> Dict[str, torch.Tensor]:
    items = [dataset[int(i)] for i in indices]
    return {"image": torch.from_numpy(np.stack([im for im, _ in items])),
            "label": torch.tensor([lab for _, lab in items],
                                  dtype=torch.int64)}


def _to_device(batch: Dict[str, torch.Tensor], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    pin = device.type == "cuda"
    return {k: (v.pin_memory() if pin else v).to(device, non_blocking=pin)
            for k, v in batch.items()}


def create_loader(dataset, batch_size: int, device: torch.device
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield {"image": uint8 (B, H, W, 3), "label": int64 (B,)} on
    ``device``; the last batch may be short."""
    for start in range(0, len(dataset), batch_size):
        idx = range(start, min(start + batch_size, len(dataset)))
        yield _to_device(_collate(dataset, idx), device)


class Loader:
    """Training batches; see the module docstring."""

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = device
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        return np.random.RandomState(self.seed + self.epoch).permutation(
            len(self.dataset))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0
                     ) -> Iterator[Dict[str, torch.Tensor]]:
        """This epoch's batches from batch index ``start`` on."""
        idx = self._indices()
        bs = self.batch_size
        pin = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            """Queue item unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for bi in range(start, len(self)):
                    batch = _collate(self.dataset, idx[bi * bs:(bi + 1) * bs])
                    if pin:
                        batch = {k: v.pin_memory() for k, v in batch.items()}
                    if not put(batch):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, raised there
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield {k: v.to(self.device, non_blocking=pin)
                       for k, v in item.items()}
        finally:
            stop.set()
            thread.join(timeout=10)
