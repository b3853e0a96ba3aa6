"""Losses of the downstream tasks (ops/losses.py). The rest of the JAX
package's ops/ (boxes, rotated boxes, RoI ops, pooling, ORN, plugins, the
native library) is not ported yet (ROADMAP queue 1, item 9)."""
from lemevit_tpu_torch.ops.losses import (  # noqa: F401
    dice_loss,
    hybrid_loss,
    jaccard_loss,
    sigmoid_focal_loss,
    softmax_focal_loss,
    tversky_loss,
)
