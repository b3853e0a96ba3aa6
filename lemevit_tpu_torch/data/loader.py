"""Minimal evaluation loader: batches of a map-style dataset, copied to the
device from pinned host memory without blocking the host."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def create_loader(dataset, batch_size: int, device: torch.device
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield {"image": uint8 (B, H, W, 3), "label": int64 (B,)} on
    ``device``; the last batch may be short."""
    pin = device.type == "cuda"
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in
                 range(start, min(start + batch_size, len(dataset)))]
        images = torch.from_numpy(np.stack([im for im, _ in items]))
        labels = torch.tensor([lab for _, lab in items], dtype=torch.int64)
        if pin:
            images, labels = images.pin_memory(), labels.pin_memory()
        yield {"image": images.to(device, non_blocking=pin),
               "label": labels.to(device, non_blocking=pin)}
