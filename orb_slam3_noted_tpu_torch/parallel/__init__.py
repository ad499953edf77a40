"""Multi-device sharding: distributed bundle adjustment over a mesh of ranks
(port of :mod:`orb_slam3_noted_tpu.parallel`).

Observations and landmark blocks shard across the ranks of a
``torch.distributed`` group; the reduced camera system is assembled with
``all_reduce`` and the small pose system is solved on every rank.
"""

from orb_slam3_noted_tpu_torch.parallel.dist_ba import (  # noqa: F401
    distributed_bundle_adjust,
    make_mesh,
    pad_obs_for_mesh,
)
from orb_slam3_noted_tpu_torch.optim.gba import (  # noqa: F401
    distributed_global_ba,
)
