"""Columnar storage: relation loading and load-time statistics.

Re-designs the reference's mmap loader (structs.cpp:17-63) for the device path:

* The on-disk contract is preserved bit-for-bit (SURVEY.md §2.4): little-endian
  ``[num_tuples u64][num_columns u64]`` then columns back-to-back column-major,
  each ``num_tuples`` uint64s; file size must equal ``(t*c + 2) * 8``
  (asserted like structs.cpp:30).
* Columns are zero-copy ``np.memmap`` views on the host. Device copies are
  narrowed to int32 when values fit (the device path's lanes); wider columns keep
  a two-plane (hi32/lo32) representation for the device path.
* Per-column stats — min / max / exact distinct count — mirror
  structs.cpp:40-61, but distinct is computed by sorting (O(n log n), no
  dense ``vector<bool>`` of size max-min+1, which SURVEY.md §8.6 calls a
  memory bomb for hash-like keys).

A native C++ loader (runtime/native.py) accelerates the host-side scan when
built; this module is the always-available pure-NumPy path with identical
results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

INT32_MAX = np.int64(2**31 - 1)


@dataclasses.dataclass
class ColumnStats:
    """Per-column min/max/distinct (reference: relList_stats, structs.h:24-31)."""
    min: int
    max: int
    distinct: int

    def copy(self) -> "ColumnStats":
        return ColumnStats(self.min, self.max, self.distinct)


class Relation:
    """A loaded columnar relation.

    ``values[c]`` is a uint64 host view of column ``c`` (zero-copy memmap when
    loaded from file). ``narrow[c]`` is an int32 copy for the 32-bit device
    fast path, or None if the column has values >= 2**31.
    """

    def __init__(self, columns: List[np.ndarray], path: Optional[str] = None,
                 compute_stats: bool = True):
        assert len(columns) > 0
        n = len(columns[0])
        for col in columns:
            assert len(col) == n, "all columns must share num_tuples"
        self.path = path
        self.num_tuples = int(n)
        self.num_columns = len(columns)
        self.values: List[np.ndarray] = columns
        self.stats: List[ColumnStats] = []
        self._narrow: List[Optional[np.ndarray]] = [None] * self.num_columns
        if compute_stats:
            self._fill_stats()

    # -- stats (reference: structs.cpp:40-61) --
    def _fill_stats(self) -> None:
        for col in self.values:
            if len(col) == 0:
                self.stats.append(ColumnStats(0, 0, 0))
                continue
            cmin = int(col.min())
            cmax = int(col.max())
            # exact distinct via sort (not a dense bitmap)
            distinct = int(len(np.unique(col)))
            self.stats.append(ColumnStats(cmin, cmax, distinct))

    def set_stats(self, stats: List[ColumnStats]) -> None:
        self.stats = stats

    @property
    def fits_narrow(self) -> bool:
        """All columns fit the int32 device fast path."""
        return all(s.max <= int(INT32_MAX) for s in self.stats)

    def narrow_column(self, c: int) -> np.ndarray:
        """int32 copy of column c (cached). Caller must have checked fits."""
        if self._narrow[c] is None:
            assert self.stats[c].max <= int(INT32_MAX), (
                f"column {c} has values >= 2**31; use the wide path")
            self._narrow[c] = self.values[c].astype(np.int32)
        return self._narrow[c]

    def destroy(self) -> None:
        """Release memmap references (reference: structs.cpp:65-72)."""
        self.values = []
        self._narrow = []


def load_relation(path: str, compute_stats: bool = True) -> Relation:
    """mmap a binary relation file (reference: relList ctor, structs.cpp:17-39)."""
    raw = np.memmap(path, dtype="<u8", mode="r")
    assert raw.size >= 2, f"{path}: truncated header"
    num_tuples = int(raw[0])
    num_columns = int(raw[1])
    assert raw.size == num_tuples * num_columns + 2, (
        f"{path}: size mismatch (structs.cpp:30 contract)")
    body = raw[2:]
    cols = [body[c * num_tuples:(c + 1) * num_tuples] for c in range(num_columns)]
    return Relation(cols, path=path, compute_stats=compute_stats)


class Catalog:
    """Ordered set of loaded relations; ids are load order (join.cpp:18-22)."""

    def __init__(self) -> None:
        self.relations: List[Relation] = []

    def add(self, rel: Relation) -> int:
        self.relations.append(rel)
        return len(self.relations) - 1

    def load(self, path: str) -> int:
        return self.add(load_relation(path))

    def __getitem__(self, i: int) -> Relation:
        return self.relations[i]

    def __len__(self) -> int:
        return len(self.relations)

    def destroy(self) -> None:
        for r in self.relations:
            r.destroy()
        self.relations = []


def write_relation(path: str, columns: List[np.ndarray]) -> None:
    """Write a relation in the reference binary format (for synthetic tests)."""
    n = len(columns[0])
    with open(path, "wb") as f:
        header = np.array([n, len(columns)], dtype="<u8")
        f.write(header.tobytes())
        for col in columns:
            f.write(np.ascontiguousarray(col, dtype="<u8").tobytes())
