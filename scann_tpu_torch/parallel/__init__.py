from scann_tpu_torch.parallel.distributed import (  # noqa: F401
    check_replicas_match,
    fetch,
    initialize,
    is_multiprocess,
    is_primary,
    process_count,
    process_index,
    put_replicated,
)
from scann_tpu_torch.parallel.mesh import (  # noqa: F401
    RankLayout,
    batch_shard,
    batch_sharding,
    hierarchical_order,
    make_mesh,
    replicated_sharding,
)
