"""Downstream heads: UperNet segmentation, change detection (BIT on a
LeMeViT, ResNet or Swin backbone; the SNUNet family) and oriented
detection (Oriented R-CNN). Mask R-CNN (lemevit_tpu/tasks/mask_rcnn.py)
is not ported yet (ROADMAP queue 1, item 11)."""
from lemevit_tpu_torch.tasks.change_detection import (  # noqa: F401
    BITChangeDetector,
    BITHead,
    TransformerBlock,
    create_bit,
)
from lemevit_tpu_torch.tasks.detection import (  # noqa: F401
    FPN,
    OBBRoIHead,
    OrientedRCNN,
    OrientedRPNHead,
    create_oriented_rcnn,
    decode_midpoint_offset,
    decode_obb_deltas,
    encode_obb_deltas,
    make_anchors,
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
