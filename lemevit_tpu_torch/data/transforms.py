"""Image normalisation: ImageNet mean/std, uint8 NHWC -> float NHWC.
Counterpart of lemevit_tpu/data/transforms.py (constants) and
lemevit_tpu/data/mixup.py::normalize."""
from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalised float NHWC, on the images' device."""
    x = images_u8.to(dtype) / 255.0
    mean = torch.tensor(mean, dtype=dtype, device=images_u8.device)
    std = torch.tensor(std, dtype=dtype, device=images_u8.device)
    return (x - mean) / std
