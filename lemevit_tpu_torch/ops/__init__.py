"""Ops of the downstream tasks: the losses (ops/losses.py), axis-aligned
and rotated boxes (ops/boxes.py, ops/rotated.py), RoI sampling
(ops/roi.py), corner pooling and masked conv (ops/pooling.py), the
Oriented Response Network ops (ops/orn.py), the plugin layers
(ops/plugins.py) and the host library of NMS and rotated IoU
(ops/native.py); the names lemevit_tpu/ops/__init__.py exports."""
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
from lemevit_tpu_torch.ops.orn import (  # noqa: F401
    active_rotating_filter,
    orconv2d,
    rotation_invariant_encoding,
    rotation_invariant_pooling,
)
from lemevit_tpu_torch.ops.plugins import (  # noqa: F401
    PLUGIN_LAYERS,
    ContextBlock,
    GeneralizedAttention,
    GlobalPoolingCell,
    NonLocal2D,
    SumCell,
    build_plugin_layer,
)
from lemevit_tpu_torch.ops.pooling import (  # noqa: F401
    bottom_pool,
    corner_pool,
    left_pool,
    masked_conv2d,
    right_pool,
    top_pool,
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
