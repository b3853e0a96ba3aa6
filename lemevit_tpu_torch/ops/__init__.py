"""Ops of the downstream tasks: the losses (ops/losses.py), axis-aligned
and rotated boxes (ops/boxes.py, ops/rotated.py), RoI sampling
(ops/roi.py) and the host library of NMS and rotated IoU (ops/native.py).
The JAX package's ops/pooling.py, ops/orn.py and ops/plugins.py are not
ported yet (ROADMAP queue 1, items 9 and 11)."""
from lemevit_tpu_torch.ops.boxes import (  # noqa: F401
    batched_nms,
    box_iou,
    nms,
    nms_indices,
    nms_match,
    soft_nms,
)
from lemevit_tpu_torch.ops.losses import (  # noqa: F401
    dice_loss,
    hybrid_loss,
    jaccard_loss,
    sigmoid_focal_loss,
    softmax_focal_loss,
    tversky_loss,
)
from lemevit_tpu_torch.ops.roi import (  # noqa: F401
    multilevel_roi_align,
    point_sample,
    roi_align,
    roi_align_rotated,
    roi_pool,
)
from lemevit_tpu_torch.ops.rotated import (  # noqa: F401
    arb_batched_nms,
    box_iou_rotated,
    convex_sort,
    obb_nms,
    obb_overlaps,
    obb_to_corners,
    poly_iou,
    poly_nms,
)
