"""Downstream heads: UperNet segmentation (the change-detection and
detection heads of lemevit_tpu/tasks are not ported yet)."""
from lemevit_tpu_torch.tasks.upernet import (  # noqa: F401
    FCNHead,
    UPerHead,
    UperNet,
    create_upernet,
    slide_inference,
)
