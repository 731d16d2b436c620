"""Per-operator profiling and roofline accounting.

The reference has no runtime observability at all (SURVEY.md §5: two
commented-out clock_t lines; its "profiler" is GCC PGO). The engine
provides:

* OpProfiler — per-operator call counts, wall time (synchronized), bytes
  touched, and % of the device's peak memory bandwidth (the engine is
  gather/scatter/sort-bound integer work, so bandwidth is the roofline
  that matters).
* jax.profiler passthrough — `with trace(dir):` for full XLA traces.

Enable with EngineConfig.profile=True; the engine then synchronizes after
every operator (accurate timing, slower wall clock) and
`engine.profiler.report()` renders the table.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, Optional

import jax

# Published peak device-memory bandwidth (bytes/s) by jax device_kind:
# the one roofline denominator of every profile and benchmark.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB HBM3 part
# (3.35 TB/s, at the card's full 700 W power limit).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device=None) -> Optional[float]:
    """Peak memory bandwidth of `device` (default: the first device).

    The CPU reports no roofline (None). An accelerator whose kind is not
    in PEAK_HBM_BYTES_PER_S raises instead of guessing a peak."""
    d = device if device is not None else jax.devices()[0]
    if d.platform == "cpu":
        return None
    if d.device_kind not in PEAK_HBM_BYTES_PER_S:
        raise ValueError(
            f"no published peak bandwidth for device kind "
            f"{d.device_kind!r}; add it to PEAK_HBM_BYTES_PER_S")
    return PEAK_HBM_BYTES_PER_S[d.device_kind]


@dataclasses.dataclass
class OpStats:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def gb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def roofline_frac(self) -> Optional[float]:
        bw = hbm_bytes_per_s()
        if bw is None or self.seconds <= 0:
            return None
        return self.bytes / self.seconds / bw


class OpProfiler:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.ops: Dict[str, OpStats] = defaultdict(OpStats)

    def record(self, name: str, result, inputs=()):
        """Time `result` to completion and account it to `name`.

        Bytes = exact nbytes of `inputs` plus every array in the result
        tree — not a hand multiplier. Callers pass only the arrays the
        op scans in full (a table that is merely point-gathered at k
        positions is omitted; its ~k-element traffic is captured by the
        same-width index/output arrays). This is a lower bound on memory
        traffic — XLA materializes at least inputs+outputs, and fusion
        only removes intermediate traffic — so the roofline column is a
        conservative % of speed-of-light.
        """
        if not self.enabled:
            return result
        t0 = time.perf_counter()
        jax.block_until_ready(result)
        dt = time.perf_counter() - t0
        s = self.ops[name]
        s.calls += 1
        s.seconds += dt
        s.bytes += arr_bytes(*inputs) + arr_bytes(
            *jax.tree_util.tree_leaves(result))
        return result

    def report(self) -> str:
        if not self.ops:
            return "(no ops recorded)"
        lines = [f"{'operator':<24}{'calls':>7}{'total s':>10}"
                 f"{'GB/s':>9}{'% roof':>8}"]
        for name, s in sorted(self.ops.items(), key=lambda kv: -kv[1].seconds):
            rf = s.roofline_frac
            roof = f"{100 * rf:>7.1f}%" if rf is not None else f"{'-':>8}"
            lines.append(f"{name:<24}{s.calls:>7}{s.seconds:>10.4f}"
                         f"{s.gb_per_s:>9.1f}{roof}")
        total = sum(s.seconds for s in self.ops.values())
        lines.append(f"{'TOTAL':<24}{'':>7}{total:>10.4f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.ops.clear()


def trace(log_dir: str):
    """Full XLA trace context (TensorBoard format)."""
    return jax.profiler.trace(log_dir)


def arr_bytes(*arrays) -> int:
    """Total byte size of jax arrays (for roofline estimates)."""
    n = 0
    for a in arrays:
        if hasattr(a, "nbytes"):
            n += a.nbytes
        elif hasattr(a, "size"):
            n += a.size * 4
    return n
