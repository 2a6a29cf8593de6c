"""Multi-device execution of the port: the device mesh of this process's
devices and the sharded DP on it (`mesh`), the column-sharded DP of one
oversized target with its boundary ring over the mesh (`colshard`),
target manifest sharding over the ranks of a `torch.distributed` group,
bucketed batching and prefetch (`scheduler`), and the completed-target
journal (`journal`)."""

from pbdagcon_tpu_torch.parallel.mesh import (  # noqa: F401
    dp_scores_sharded,
    make_mesh,
    metrics_allreduce,
)
from pbdagcon_tpu_torch.parallel.colshard import colsharded_scores  # noqa: F401
from pbdagcon_tpu_torch.parallel.journal import TargetJournal  # noqa: F401
from pbdagcon_tpu_torch.parallel.scheduler import (  # noqa: F401
    BucketScheduler,
    shard_for_host,
)
