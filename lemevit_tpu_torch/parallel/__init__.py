"""Multi-process training: the process group (distributed.py) and the
data x model layout with the tensor-parallel rules (mesh.py)."""
from lemevit_tpu_torch.parallel.distributed import (  # noqa: F401
    Shard,
    init_distributed,
)
from lemevit_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    build_mesh,
    param_spec,
)
