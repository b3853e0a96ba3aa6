"""Downstream heads: UperNet segmentation and change detection (BIT on a
LeMeViT, ResNet or Swin backbone; the SNUNet family). The detection heads
of lemevit_tpu/tasks are not ported yet (ROADMAP queue 1, items 10-11)."""
from lemevit_tpu_torch.tasks.change_detection import (  # noqa: F401
    BITChangeDetector,
    BITHead,
    TransformerBlock,
    create_bit,
)
from lemevit_tpu_torch.tasks.snunet import (  # noqa: F401
    SiamNestedUNetConc,
    SiamUnetDiff,
    SNUNetECAM,
)
from lemevit_tpu_torch.tasks.upernet import (  # noqa: F401
    FCNHead,
    UPerHead,
    UperNet,
    create_upernet,
    slide_inference,
)
