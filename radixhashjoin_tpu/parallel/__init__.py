"""Multi-chip execution: device mesh + distributed radix-exchange join.

The reference has no distributed backend at all (SURVEY.md §5): its
"parallelism" is a 72-thread pthread pool over shared memory. The array
equivalent is a `jax.sharding.Mesh` with `shard_map` programs whose stage
structure mirrors the reference's bulk-synchronous histogram → partition →
join pipeline, with XLA collectives as the stage boundaries:

  per-chunk histograms + serial merge (structs.cpp:111-121,168-173)
      -> per-shard bincount + `psum`
  partition scatter into disjoint ranges (structs.cpp:123-134)
      -> level-0 radix binning + `lax.all_to_all` exchange between chips
  per-bucket build/probe jobs (Result.cpp:100-107)
      -> per-chip sort+searchsorted on its digits
"""

from .mesh import make_mesh
from .dist_join import (dist_join_count_sum, dist_join_skewaware,
                        radix_exchange)
from .dist_executor import DistExecutor

__all__ = ["make_mesh", "dist_join_count_sum", "dist_join_skewaware",
           "radix_exchange", "DistExecutor"]
