"""lemevit_tpu_torch: LeMeViT in PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a), beside the JAX package ``lemevit_tpu``.

Entry points run on the GPU unless the caller asks for the CPU
(``create_model(..., device="cpu")``, ``--device cpu``); without a CUDA
device they raise. The whole pre-norm C, D/D2 and S blocks run as
hand-written kernels: in inference the fused kernels of
``attn/fused_block.py``, in training (``cli/train.py``) the training kernels
of ``attn/fused_train.py``. Blocks those kernels do not take (above their
token counts, as in UperNet segmentation at 512^2, ``cli/train_seg.py``)
compose, their attention on the attention-only kernels of ``attn/dca.py``
and ``attn/mhsa.py``.
"""

__version__ = "0.1.0"

from lemevit_tpu_torch.models.lemevit import LeMeBlock, LeMeViT  # noqa: F401
from lemevit_tpu_torch.models.registry import (  # noqa: F401
    create_model,
    list_models,
    resolve_device,
    variant_config,
)
