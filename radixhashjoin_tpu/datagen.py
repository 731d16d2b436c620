"""Seeded workload generator in the SIGMOD-2018 programming-contest format.

The contest's public workload is 14 binary relations of 2-7 uint64 columns
and a work stream of query batches, each query joining 2-4 relation slots
with 1-3 equi-joins, one filter and 1-3 SUM projections, every batch ending
in ``F`` (SURVEY.md §2.1 row 16). This module builds such a workload from a
seed, at any scale, so that every test and the on-card smoke run have data
without any external files.

Schema (fixed shape, seeded content): relation ``i`` has a unique key
column 0, foreign-key columns that reference the key domain of a relation
with a larger id (or its own, for hierarchical self-references), and
payload columns. About a tenth of every foreign-key column misses its
parent, so joins drop rows. All values share one key domain, so any two
key columns can join. Queries walk the foreign-key graph: every join is
key = foreign key, written so that each new join attaches one new slot.
The generator also writes:

* self-joins: one relation bound to two slots through its own foreign key;
* parallel edges: a join repeated in reverse, which the engine rewrites
  into a same-slot selection (models/batch.py:_extract_tree);
* triangles: three slots joined in a cycle, where the closing join is a
  both-joined (case 3) step of the reference's chaining.

Outputs: ``write_workload(w, dir)`` writes ``r0``..``r13`` in the binary
format of storage.py plus ``contest.init`` / ``contest.work``; ``python -m
radixhashjoin_tpu.datagen --out DIR [--seed S] [--scale X] [--result]``
does the same from the shell (``--result`` adds ``contest.result`` from
oracle.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List

import numpy as np

from .storage import Relation, write_relation
from .workload import Query, parse_query

N_RELATIONS = 14
N_QUERIES = 50
N_BATCHES = 5
# tuples per relation at scale 1: the contest's small workload spans
# 1,561..43,131 rows (269,311 in all)
_MIN_ROWS, _MAX_ROWS = 1500, 45000


@dataclasses.dataclass
class Workload:
    """Generated relations (uint64 columns) and query batches."""
    columns: List[List[np.ndarray]]
    batches: List[List[Query]]

    def relations(self) -> List[Relation]:
        return [Relation(cols) for cols in self.columns]

    def work_text(self) -> str:
        return "".join("".join(q.text + "\n" for q in b) + "F\n"
                       for b in self.batches)


def _schema(rng):
    """Per relation: row count, column count and foreign-key columns."""
    rows = np.exp(rng.uniform(np.log(_MIN_ROWS), np.log(_MAX_ROWS),
                              N_RELATIONS)).astype(np.int64)
    ncols = rng.integers(2, 8, N_RELATIONS)
    # a fixed triangle so that every workload can close a cycle:
    # r0 -> r1, r0 -> r2, r1 -> r2
    ncols[0], ncols[1] = max(ncols[0], 3), max(ncols[1], 2)
    fks = []
    for i in range(N_RELATIONS):
        cols = []
        for c in range(1, ncols[i]):
            if i == 0 and c in (1, 2):
                parent = c
            elif i == 1 and c == 1:
                parent = 2
            elif i == N_RELATIONS - 1 and c == 1:
                parent = i                      # one sure self-reference
            elif rng.random() < 0.55:
                # a parent with a larger id keeps the graph acyclic; the
                # last relation references itself
                parent = (int(rng.integers(i + 1, N_RELATIONS))
                          if i + 1 < N_RELATIONS else i)
            elif rng.random() < 0.2:
                parent = i                      # hierarchical self-reference
            else:
                continue                        # payload column
            cols.append((c, parent))
        fks.append(cols)
    return rows, ncols, fks


def _relations(rng, rows, ncols, fks, domain):
    # unique keys: r -> (a*r + b) mod domain is a bijection of [0, domain)
    # for odd a and a power-of-two domain
    keys = [((np.arange(n, dtype=np.uint64)
              * np.uint64(2 * rng.integers(0, domain // 2) + 1)
              + np.uint64(rng.integers(0, domain)))
             & np.uint64(domain - 1)) for n in rows]
    columns = []
    for i in range(N_RELATIONS):
        n = int(rows[i])
        fk_of = dict(fks[i])
        cols = [keys[i]]
        for c in range(1, ncols[i]):
            if c in fk_of:
                pk = keys[fk_of[c]]
                # skewed references: parent k is drawn with density
                # ~ 1/sqrt(k), so the first parents own the most children
                ref = pk[(len(pk) * rng.random(n) ** 2).astype(np.int64)]
                miss = rng.random(n) < 0.1
                ref[miss] = rng.integers(0, domain, int(miss.sum()))
                cols.append(ref.astype(np.uint64))
            else:
                hi = int(rng.choice([100, 1000, domain]))
                cols.append(rng.integers(0, hi, n).astype(np.uint64))
        columns.append(cols)
    return columns


def _filter(rng, columns, rel, slot):
    c = int(rng.integers(0, len(columns[rel])))
    col = columns[rel][c]
    op = str(rng.choice(["<", ">", "="], p=[0.45, 0.45, 0.1]))
    if op == "=":
        k = int(col[rng.integers(0, len(col))])
    else:
        k = int(np.quantile(col, rng.uniform(0.2, 0.8)))
    return f"{slot}.{c}{op}{k}"


def _query(rng, columns, fks, kind):
    """One query: slots, predicate list and projections, as text."""
    edges = [(i, c, p) for i in range(N_RELATIONS) for (c, p) in fks[i]]
    if kind == "triangle":
        slots = [0, 1, 2]
        # r0.1 -> r1.0, r1.1 -> r2.0, then r0.2 -> r2.0 closes the cycle
        joins = ["0.1=1.0", "1.1=2.0", "0.2=2.0"]
    elif kind == "self":
        i, c, _p = [e for e in edges if e[0] == e[2]][
            int(rng.integers(0, sum(e[0] == e[2] for e in edges)))]
        slots = [i, i]
        joins = [f"0.{c}=1.0"]
        _grow(rng, edges, slots, joins, int(rng.integers(0, 2)))
    else:
        slots = [int(rng.integers(0, N_RELATIONS))]
        joins = []
        _grow(rng, edges, slots, joins,
              int(rng.integers(1, 3 if kind == "parallel" else 4)))
        if kind == "parallel" and joins:
            a, b = joins[int(rng.integers(0, len(joins)))].split("=")
            joins.append(f"{b}={a}")
    preds = list(joins)
    fs = int(rng.integers(0, len(slots)))
    preds.insert(int(rng.integers(0, len(preds) + 1)),
                 _filter(rng, columns, slots[fs], fs))
    projs = []
    for _ in range(int(rng.integers(1, 4))):
        s = int(rng.integers(0, len(slots)))
        projs.append(f"{s}.{int(rng.integers(0, len(columns[slots[s]])))}")
    return " ".join(map(str, slots)) + "|" + "&".join(preds) + "|" + \
        " ".join(projs)


def _grow(rng, edges, slots, joins, n_joins):
    """Attach n_joins new slots, each by one key = foreign-key join to a
    slot already in the query (either direction of a schema edge). At most
    one join per query fans out (a new child's foreign key = a slot's key),
    so no query's joined multiset outgrows its largest relation."""
    fanned = False
    for _ in range(n_joins):
        if len(joins) >= 3:
            return
        cand = []
        for s, rel in enumerate(slots):
            for (i, c, p) in edges:
                if i == rel:                       # slot's fk -> new parent
                    cand.append((f"{s}.{c}", p, "0"))
                if p == rel and not fanned:        # new child's fk -> slot
                    cand.append((f"{s}.0", i, str(c)))
        if not cand:
            return
        ref, rel, col = cand[int(rng.integers(0, len(cand)))]
        fanned = fanned or col != "0"
        new = len(slots)
        slots.append(rel)
        joins.append(f"{ref}={new}.{col}" if rng.random() < 0.5
                     else f"{new}.{col}={ref}")


def generate(seed: int = 0, scale: float = 1.0) -> Workload:
    """The seeded workload: 14 relations, 50 queries in 5 batches.

    scale multiplies every relation's row count; the key domain grows
    with it (values stay below 2**31 for any scale that fits a host)."""
    rng = np.random.default_rng(seed)
    rows, ncols, fks = _schema(rng)
    rows = np.maximum((rows * scale).astype(np.int64), 2)
    domain = 1 << int(np.ceil(np.log2(rows.max() * 1.5)))
    columns = _relations(rng, rows, ncols, fks, domain)
    kinds = (["triangle", "self", "parallel", "parallel"]
             + ["tree"] * (N_QUERIES - 4))
    order = rng.permutation(N_QUERIES)
    texts = [_query(rng, columns, fks, kinds[k]) for k in order]
    queries = [parse_query(t) for t in texts]
    per = N_QUERIES // N_BATCHES
    batches = [queries[b * per:(b + 1) * per] for b in range(N_BATCHES)]
    return Workload(columns, batches)


def write_workload(w: Workload, out_dir: str, prefix: str = "") -> List[str]:
    """Write r0..r13, contest.init and contest.work into out_dir. The init
    stream names each relation as ``prefix + "r<i>"``. Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, cols in enumerate(w.columns):
        p = os.path.join(out_dir, f"r{i}")
        write_relation(p, cols)
        paths.append(p)
    with open(os.path.join(out_dir, "contest.init"), "w") as f:
        f.write("".join(f"{prefix}r{i}\n" for i in range(len(w.columns)))
                + "Done\n")
    with open(os.path.join(out_dir, "contest.work"), "w") as f:
        f.write(w.work_text())
    return paths


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--result", action="store_true",
                   help="also write contest.result (oracle.py's answers)")
    args = p.parse_args()
    w = generate(args.seed, args.scale)
    write_workload(w, args.out)
    if args.result:
        from .oracle import run_workload
        with open(os.path.join(args.out, "contest.result"), "w") as f:
            f.write("".join(line + "\n" for line in
                            run_workload(w.relations(), w.batches)))


if __name__ == "__main__":
    main()
