"""The mesh plane: multi-replica engines, sharded GP scoring and the
multi-process bootstrap (counterpart of `uptune_tpu/parallel/`, over
`parallel/mesh.py`'s named-axis meshes and `torch.distributed`)."""
from .multihost import (distributed_config, initialize,  # noqa: F401
                        is_coordinator, make_multihost_mesh)
from .sharded import ShardedEngine, make_mesh  # noqa: F401
from .surrogate_shard import sharded_gp_score  # noqa: F401
