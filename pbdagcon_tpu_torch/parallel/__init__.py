"""Multi-device execution of the port. This slice carries the
completed-target journal and the column-sharded DP of one oversized
target on one card (`colshard`); the mesh, the sharded DP and the
scheduler come with the multi-device slice (ROADMAP A14)."""

from pbdagcon_tpu_torch.parallel.colshard import colsharded_scores  # noqa: F401
from pbdagcon_tpu_torch.parallel.journal import TargetJournal  # noqa: F401
