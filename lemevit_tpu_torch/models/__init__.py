"""LeMeViT model, registry and checkpoint helpers."""
from lemevit_tpu_torch.models.lemevit import LeMeBlock, LeMeViT  # noqa: F401
from lemevit_tpu_torch.models.registry import (  # noqa: F401
    create_model,
    list_models,
    variant_config,
)
