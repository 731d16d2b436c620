"""Device operators (JAX/XLA).

Everything here works on *padded* arrays with an explicit live `count`
(see utils/padding.py): XLA requires static shapes, so data-dependent sizes
use the count-then-materialize two-pass discipline (SURVEY.md §7 hard part a).
"""

from .compact import compact, compact_mask_positions
from .filter import filter_live, OP_EQ, OP_LT, OP_GT
from .join import probe_count, expand_pairs, any_common
from .aggregate import sum_column_over_rows

__all__ = [
    "compact", "compact_mask_positions",
    "filter_live", "OP_EQ", "OP_LT", "OP_GT",
    "probe_count", "expand_pairs", "any_common",
    "sum_column_over_rows",
]
