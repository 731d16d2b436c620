"""Engine facade: catalog + executor + workload runner.

The array-program replacement for the reference's main() lifecycle
(join.cpp:11-62) and its 72-thread MainScheduler/JobScheduler runtime
(MainScheduler.cpp, JobScheduler.cpp): relations are loaded once, queries
execute as compiled array programs, and results print in input order.
Inter-query parallelism comes from XLA's async dispatch — every device call
is non-blocking, so the host pipelines the next query's work while the
device executes — instead of a thread pool.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, TextIO

from ..config import EngineConfig, DEFAULT
from ..oracle import OracleExecutor, format_result
from ..storage import Catalog, Relation, load_relation
from ..workload import Query, parse_init_stream, parse_work_stream
from .batch import BatchExecutor
from .executor import JaxExecutor
from .planner import reorder_joins


class Engine:
    """End-to-end engine over a set of loaded relations."""

    def __init__(self, relations: Sequence[Relation],
                 config: EngineConfig = DEFAULT):
        self.relations = list(relations)
        self.config = config
        self._oracle = OracleExecutor(self.relations)
        if config.mesh_devices:
            # distributed execution path: live sets + intermediates
            # row-sharded over an n-device mesh (parallel/dist_executor.py)
            from ..parallel import DistExecutor
            self.dist_executor = DistExecutor(
                self.relations, config, n_devices=config.mesh_devices)
            self.batch_executor = None
            self.executor = None
        else:
            self.dist_executor = None
            self.batch_executor = BatchExecutor(self.relations, config)
            self.executor = JaxExecutor(self.relations, config,
                                        catalog=self.batch_executor.catalog)

    @classmethod
    def from_paths(cls, paths: Sequence[str],
                   config: EngineConfig = DEFAULT) -> "Engine":
        """Load relations, preferring the native (C++) loader when built."""
        from ..runtime import load_relation_native, native_available
        if config.use_native_runtime and native_available():
            return cls([load_relation_native(p) for p in paths], config)
        return cls([load_relation(p) for p in paths], config)

    def execute(self, q: Query) -> Optional[List[int]]:
        """One query -> projection sums or None (NULL line).

        Full-u64 columns run on device via the catalog's order-preserving
        dictionary encoding (models/device_catalog.py) — matching the
        reference's native u64 capability (structs.h:11-22) with int32
        device lanes. The oracle runs only under force_oracle (debug).
        """
        q = self._plan(q)
        if self.config.force_oracle:
            return self._oracle.execute(q)
        if self.dist_executor is not None:
            return self.dist_executor.execute(q)
        return self.executor.execute(q)

    def _plan(self, q: Query) -> Query:
        """Stats-driven join reordering (the optimizer the reference never
        implemented, README.md:62-64); off by default for written-order
        parity."""
        if self.config.enable_join_reordering:
            return reorder_joins(q, self.relations)
        return q

    def run_batch_raw(self, batch: Sequence[Query]
                      ) -> List[Optional[List[int]]]:
        """One query batch, wave-parallel on device (models/batch.py) —
        the array analog of the reference executing every query of a
        batch concurrently on its thread pool (join.cpp:42-49). Returns
        per-query sums (None = NULL line), unformatted. On a mesh the
        factorizable queries run as d_ftree waves
        (DistExecutor.run_batch_raw)."""
        if self.config.force_oracle or not self.config.batch_execution:
            return [self.execute(q) for q in batch]
        planned = [self._plan(q) for q in batch]
        if self.dist_executor is not None:
            return self.dist_executor.run_batch_raw(planned)
        return self.batch_executor.run_batch(planned)

    def run_batch(self, batch: Sequence[Query]) -> List[str]:
        out = self.run_batch_raw(batch)
        return [format_result(out[i], len(q.projections))
                for i, q in enumerate(batch)]

    def run_workload_raw(self, batches: Sequence[Sequence[Query]]
                         ) -> List[Optional[List[int]]]:
        """All batches at once: batch framing is parse-level only — the
        reference also schedules every query of every batch before printing
        (join.cpp:42-55, SURVEY.md §8.11). One mega-batch maximizes wave
        width and minimizes readbacks."""
        if self.config.batch_execution and len(batches) > 1:
            flat = [q for batch in batches for q in batch]
            return self.run_batch_raw(flat)
        out: List[Optional[List[int]]] = []
        for batch in batches:
            out.extend(self.run_batch_raw(batch))
        return out

    def run_workload(self, batches: Sequence[Sequence[Query]]) -> List[str]:
        raw = self.run_workload_raw(batches)
        queries = [q for batch in batches for q in batch]
        return [format_result(r, len(q.projections))
                for r, q in zip(raw, queries)]


_LAST_ENGINE: Optional[Engine] = None


def main(stdin: TextIO = None, stdout: TextIO = None,
         config: EngineConfig = DEFAULT) -> None:
    """stdin-protocol driver, contract-identical to the reference binary:
    relation paths until `Done`, then query batches (`F`-terminated), then
    one result line per query in input order (join.cpp:11-62).
    """
    from ..runtime import (format_results_native, parse_work_native,
                           native_available)

    global _LAST_ENGINE
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    paths = parse_init_stream(stdin)
    try:
        engine = Engine.from_paths(paths, config)
    except (OSError, AssertionError) as e:
        # the reference asserts/aborts here (structs.cpp:19-30); be civil
        print(f"radixhashjoin_tpu: cannot load relations: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    _LAST_ENGINE = engine
    try:
        if config.use_native_runtime and native_available():
            batches = parse_work_native(stdin.read())
        else:
            batches = parse_work_stream(stdin)
    except (ValueError, IndexError) as e:
        print(f"radixhashjoin_tpu: malformed work stream: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    if config.use_native_runtime and native_available():
        raw = engine.run_workload_raw(batches)
        proj_counts = [len(q.projections) for b in batches for q in b]
        stdout.write(format_results_native(raw, proj_counts))
    else:
        for line in engine.run_workload(batches):
            stdout.write(line + "\n")
