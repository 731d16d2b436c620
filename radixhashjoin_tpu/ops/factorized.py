"""Factorized (message-passing) aggregation over tree-shaped join queries.

The reference materializes every join's output rows and sums at the end
(update_intermediate, /root/reference/intermediate.cpp:146-183 +
column_proj, /root/reference/Query.cpp:66-74) — 97.7% of its runtime.
The engine's deferred-attach machinery already avoids materializing
SOME joins; this module generalizes it to the whole query: when the
join sequence forms a TREE (every join attaches a fresh slot — after
case-3 rewriting, all 50 golden queries), NOTHING is ever materialized.
SUM projections factor into per-relation "count messages" over the join
tree (the classic Yannakakis / factorized-aggregation structure):

  up pass    beta[s][r]  = product over child edges e of B_e[key_s(r)]
             B_e[v]      = sum of beta[child] over live child rows with
                           child key == v   (one dense scatter-add table)
  down pass  alpha[c][r] = A_e[key_c(r)]
             A_e[v]      = sum over live parent rows of alpha[parent] *
                           (product of the OTHER children's contribs)
  SUM(s, col) = sum over live rows r of col[r] * alpha[s][r] * beta[s][r]

Filters and same-slot selections are BOOLEAN MASKS here, not compacted
rowid sets: a compare is a free VPU op while the reference's erase loops
(Query.cpp:91-146) and the engine's own compaction scatters cost a full
scatter kernel each. Every operator runs at RAW relation length (<= 43K
on the golden data) — no padding, no gathers through live sets — so the
only remaining gather/scatter kernels are the message tables themselves,
and a pristine (unfiltered, selection-free) leaf's B table comes
precomputed from the catalog (DeviceCatalog.bincount_table).

WAVE BATCHING (run_ftree_wave): every non-fused scatter/gather kernel
carries a fixed launch cost, so a 50-query batch at ~5 kernels/query
pays it ~250 times regardless of data size. The wave runner executes
MANY queries' trees in one program, merging every scatter and gather at
the same tree LEVEL across queries into one segmented kernel (each edge
owns a width-sized slice, offsets = running sums of the per-edge widths):
kernel count drops from O(queries x edges) to O(tree height).

Per-row weights alpha*beta are exact in int32 under host-checked caps
derived from load-time max multiplicities (models/batch.py:_ftree_caps);
any query exceeding a cap falls back to the materialized path.

NULL semantics match the reference exactly: NULL iff a filter emptied a
slot (per-filtered-node emptiness flags, covering slots outside the
final tree too) or any JOIN step produced zero pairs
(/root/reference/Query.cpp:188-191); same-slot predicates never NULL.
With all selections at-or-before the last join, "some join emptied" ==
"final joined multiset empty", tested wrap-proof as
any(mask_root & beta_root > 0). Components wiped by a later case-1 join
(SURVEY.md §8.5) still gate NULL via flag-only trees, which run in the
boolean semiring (0/1 messages — no overflow caps needed).

Spec layout (static, hashable — built by models/batch.py:_plan_ftree).
Note it carries NO slot indices: two structurally identical trees over
different relations share one compiled program.

  spec = (filts, n_sels, edges, flag_nodes, root, projs, trail, tsels)
    filts:      per node, tuple of filter opcodes (ops/filter.py
                OP_EQ/OP_LT/OP_GT); each consumes one col + one val
    n_sels:     per node, number of same-slot equality selections
                (each consumes two cols)
    edges:      (parent_node, child_node, pre_flag, needs_down, width)
                in bottom-up order (every child edge precedes its
                parent's); standalone flag-only nodes have no edges.
                width = power of two spanning BOTH key columns' code
                ranges — the edge's message tables are width-sized, so
                a level's segmented table is sum-of-widths long instead
                of n_edges * catalog_domain (smaller zero-fill, smaller
                scatters, and small-domain fast paths become reachable
                even when an unrelated column blows up the global
                domain)
    flag_nodes: node indices whose mask-emptiness raises a NULL flag
                (every filtered node, including slots outside the tree)
    root:       the tree's root node index (M-emptiness flag source);
                -1 for specs without a joined component
    projs:      tuple of (node,) — one per emitted partial (one 16-bit
                plane of a projected column), each a (5, 3)
                weighted_partials_segments fold (decode on host with
                utils/limbs.py:combine_weighted_segments)
    trail:      None, or (node, born_of_join, width) — ONE selection sitting
                AFTER the last join (consumes two cols). It filters the
                final multiset (rides messages + sum weights) but not
                the NULL flags; it REPLACES the root M-emptiness flag
                with a pre-selection gate: born_of_join (a rewritten
                case-3 edge, models/batch.py:_extract_tree) => NULL iff
                the edge's pair set is empty (support-intersection
                test); native => NULL iff the pre-selection multiset is
                empty. Oracle semantics: oracle.py:121-142.
                OR (node_a, True, width, node_b) — a CROSS-NODE pair
                gate for a TRAILING composite-key fusion (a parallel
                case-3 edge with no join after it): tsel_a lives on
                node_a, tsel_b on node_b, and NULL iff no value of
                tsel_a over node_a's participating rows equals any value
                of tsel_b over node_b's participating rows (the
                reference's step pair-set rule, oracle.py:133-142,
                evaluated on the PRE-fusion tree). Such a spec is
                flag-only; its fused twin (same tree with the pair fused
                into the edge key, root = -1) carries the sums.
    tsels:      tuple of node indices — ADDITIONAL trailing same-slot
                selections (two cols each, after the trail pair). Each
                masks its node's outgoing messages and sum weights
                (msg_mask) but never the NULL flags. A spec with tsels
                has trail=None and root=-1 (its sums see every trailing
                mask, so neither the root flag nor a single-node gate
                could decide NULL from it); a flag-only COMPANION spec
                of the same tree WITHOUT any trailing entry carries the
                NULL gate instead — trailing masks on OTHER nodes would
                otherwise leak into this node's alpha/beta and turn the
                pre-trailing participation test post-trailing
                (models/batch.py "masked"/"pregate" variants).

Column/value consumption order (must match the planner):
  cols: 1. per node in node order: its filter columns, then its
           selection column pairs
        1b. the trailing selection's column pair, if any
        1c. per tsels entry, in order: its column pair
        2. per edge in edge order: parent key column, child key column
        3. per edge with pre_flag, in edge order: the precomputed
           bincount table
        4. per projection, in projs order: the plane column
  vals: per node in node order: its filter constants
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import limbs as _limbs
from ..utils.limbs import (seg_chunk, weighted_partials_big,
                           weighted_partials_segments)
from .filter import OP_EQ, OP_LT
from .tables import scatter_add, scatter_add_window, table_gather

# waves/gathers past this many rows switch to the HBM-bounded paths
# (no-concat per-projection folds; lazy gathers)
_BIG_WAVE_ROWS = 1 << 28


class _Tree:
    """Per-spec traced state inside a wave."""

    __slots__ = ("spec", "edges", "flag_nodes", "root", "projs",
                 "mask", "msg_mask", "tnode", "tnode_b", "tborn", "twidth",
                 "tsel_a", "tsel_b",
                 "pkey", "ckey", "pre", "children", "boolean",
                 "beta", "contrib", "alpha", "planes",
                 "by_height", "by_depth", "done_folds", "done_flag")


def _parse_spec(spec, cols, vals, shard=None):
    """Consume one spec's cols/vals (doc order above) into a _Tree:
    masks, key columns, pre tables, plus static height/depth schedules
    for the wave's level-batched passes.

    shard (distributed mode): (slicer, valid) — slicer(col, node) cuts
    this chip's row range out of a replicated node column, valid(node)
    is the boolean mask of real (non-pad, non-duplicate) rows in that
    slice. Pre tables are GLOBAL bincounts and are never sliced."""
    filts, n_sels, edges, flag_nodes, root, projs, trail, tsels = spec
    k = len(filts)
    t = _Tree()
    t.spec = spec
    t.edges = edges
    t.flag_nodes = flag_nodes
    t.root = root
    t.projs = projs
    ci = vi = 0

    if shard is None:
        def node_col_raw(i):
            nonlocal ci
            c = cols[ci]
            ci += 1
            return c
    else:
        slicer, _valid = shard

        def node_col_raw(i):
            nonlocal ci
            c = slicer(cols[ci], i)
            ci += 1
            return c

    def next_col():
        nonlocal ci
        c = cols[ci]
        ci += 1
        return c

    # per-node boolean masks: filters + same-slot selections, all free
    # VPU compares at raw relation length; in distributed mode the
    # shard-validity mask seeds every node (pad/duplicate rows dead)
    mask = []
    for i in range(k):
        m = None if shard is None else shard[1](i)
        for opc in filts[i]:
            c = node_col_raw(i)
            v = vals[vi]
            vi += 1
            if opc == OP_EQ:
                tt = c == v
            elif opc == OP_LT:
                tt = c < v
            else:
                tt = c > v
            m = tt if m is None else m & tt
        for _ in range(n_sels[i]):
            a = node_col_raw(i)
            b = node_col_raw(i)
            tt = a == b
            m = tt if m is None else m & tt
        mask.append(m)           # None == all rows live
    t.mask = mask

    # the trailing selection (at most one, models/batch.py:_extract_tree)
    # filters the FINAL multiset: it rides the outgoing messages and sum
    # weights (msg_mask) but stays out of `mask`, which feeds the NULL
    # flags — a trailing selection may zero every sum without NULLing
    # (oracle.py:121-124,133-142). A projection-free final comp runs
    # boolean; the part/hit gate only tests >0, so clamped messages stay
    # correct there.
    t.msg_mask = list(mask)
    t.tnode = t.tnode_b = t.tsel_a = t.tsel_b = t.tborn = t.twidth = None
    if trail is not None and len(trail) == 4:
        # cross-node pair gate (trailing composite-key fusion): the
        # predicate itself is enforced by the fused twin spec — this
        # spec only decides NULL, so messages stay unmasked here
        t.tnode, t.tborn, t.twidth, t.tnode_b = trail
        t.tsel_a = node_col_raw(t.tnode)
        t.tsel_b = node_col_raw(t.tnode_b)
    elif trail is not None:
        t.tnode, t.tborn, t.twidth = trail
        t.tsel_a = node_col_raw(t.tnode)
        t.tsel_b = node_col_raw(t.tnode)
        tsel = t.tsel_a == t.tsel_b
        t.msg_mask[t.tnode] = (tsel if mask[t.tnode] is None
                               else mask[t.tnode] & tsel)

    # additional trailing selections: final-multiset masks only (the
    # NULL gate lives in a trailing-free companion spec — see docstring)
    for node in tsels:
        a = node_col_raw(node)
        b = node_col_raw(node)
        eq = a == b
        t.msg_mask[node] = (eq if t.msg_mask[node] is None
                            else t.msg_mask[node] & eq)

    t.pkey, t.ckey = [], []
    for (p, c, _pre, _nd, _w) in edges:
        t.pkey.append(node_col_raw(p))
        t.ckey.append(node_col_raw(c))
    t.pre = []
    for (_p, _c, pre_flag, _nd, w) in edges:
        # precomputed bincounts are catalog-domain long; the edge only
        # spans its own width (slicing drops nothing: codes <= width-1)
        t.pre.append(next_col()[:w] if pre_flag else None)
    t.planes = [node_col_raw(i) for (i,) in projs]

    t.children = {i: [] for i in range(k)}
    for ei, (p, _c, _pre, _nd, _w) in enumerate(edges):
        t.children[p].append(ei)

    # flag-only trees (no projs — wiped components gating NULL) run in
    # the BOOLEAN semiring: 0/1 messages, table entries bounded by the
    # child's row count, so no overflow caps are needed for them
    t.boolean = not projs
    t.beta = [None] * k
    t.alpha = [None] * k
    t.contrib = [None] * len(edges)
    t.done_folds = {}        # proj index -> (5, 3) fold from a fused pass
    t.done_flag = None       # per-chip any(weight > 0) from a fused pass

    # static schedules. height(e) = 1 + max height of the child node's
    # incoming edges (bottom-up order makes this a single sweep); a
    # parent's edge always has greater height than every edge into its
    # child, so processing heights in order keeps beta[child] final
    # before its edge fires.
    height = [0] * len(edges)
    node_h = {}
    t.by_height = {}
    for ei, (p, c, _pre, _nd, _w) in enumerate(edges):
        h = node_h.get(c, 0) + 1
        height[ei] = h
        node_h[p] = max(node_h.get(p, 0), h)
        t.by_height.setdefault(h, []).append(ei)
    # depth(e) = distance of the parent node from the root along
    # needs_down edges (needs_down(e) implies needs_down(incoming(p)),
    # so the chain is always assigned)
    incoming = {c: ei for ei, (_p, c, _pre, _nd, _w) in enumerate(edges)}
    depth = {}
    t.by_depth = {}
    for ei in reversed(range(len(edges))):     # top-down
        p, c, _pre, needs_down, _w = edges[ei]
        if not needs_down:
            continue
        d = depth[incoming[p]] + 1 if p in incoming else 0
        depth[ei] = d
        t.by_depth.setdefault(d, []).append(ei)
    return t


def _concat(parts):
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _win_rows() -> int:
    # window length of every huge-node loop; min() lets tests shrink it
    # by monkeypatching _BIG_WAVE_ROWS
    return min(1 << 26, _BIG_WAVE_ROWS)


def _win_guard(n: int) -> None:
    """Window starts (i * w_rows) and dynamic_slice offsets are int32;
    past ~2**31 they would wrap negative and silently re-visit window 0.
    Raise loudly instead (nothing that big fits one chip anyway)."""
    if n >= (1 << 31) - (1 << 26):
        raise ValueError(
            f"huge-node window loops cap below 2**31 rows (int32 window "
            f"addressing); got {n}")


def _slice_cached(arr, start, size, cache):
    """dynamic_slice with per-window CSE: the same operand sliced by
    several consumers of a fused pass reads HBM once."""
    if cache is None:
        return jax.lax.dynamic_slice(arr, (start,), (size,))
    ck = ("s", id(arr))
    if ck not in cache:
        cache[ck] = jax.lax.dynamic_slice(arr, (start,), (size,))
    return cache[ck]


class _Lazy:
    """An unmaterialized per-row weight over a HUGE node: the
    elementwise product of window-evaluable factors.

    Materializing one message gather at 2**30 keys costs 4 GB of device
    memory; a star join multiplies SEVERAL of them — the difference
    between a 1B-row fact table fitting one chip and not. Factors:

      ("gather", table, keys, off, clamp) — table[keys + off], clamped
          to 0/1 for boolean trees; the offset into the level's
          concatenated table is applied per WINDOW, so no keys-length
          `keys + off` copy ever exists
      ("mat", vec)   — an already-materialized int32 vector
      ("mask", bvec) — boolean; False rows contribute weight 0

    Every consumer evaluates window by window (O(window) temps):
    projection folds via utils/limbs.py:weighted_partials_big's
    weight_fn, message builds via _scatter_add_big, emptiness flags via
    _lazy_any_positive. Products stay int32-exact under the planner's
    host-checked overflow caps (models/batch.py:_ftree_caps), exactly
    as the materialized path's products do."""

    __slots__ = ("n", "factors")

    def __init__(self, n, factors):
        _win_guard(n)
        self.n = n
        self.factors = list(factors)

    @classmethod
    def gather(cls, table, keys, off, clamp):
        return cls(keys.shape[0],
                   [("gather", table, keys, np.int32(off), bool(clamp))])

    def with_mask(self, bvec):
        return (self if bvec is None
                else _Lazy(self.n, self.factors + [("mask", bvec)]))

    def _parts(self, start, size, cache=None):
        for f in self.factors:
            if f[0] == "gather":
                _tag, table, keys, off, clamp = f
                k = _slice_cached(keys, start, size, cache)
                ck = ("g", id(table), id(keys), int(off), clamp)
                if cache is not None and ck in cache:
                    yield cache[ck], clamp
                    continue
                g = table_gather(table, k + off)
                g = (g > 0) if clamp else g
                if cache is not None:
                    cache[ck] = g
                yield g, clamp
            elif f[0] == "mat":
                yield _slice_cached(f[1], start, size, cache), False
            else:
                yield _slice_cached(f[1], start, size, cache), True

    def window(self, start, size, cache=None):
        """int32 weights for rows [start, start+size). `cache` (optional
        dict): per-window common-subexpression store shared across the
        consumers of one fused pass — a gather factor or operand slice
        evaluated once per window is reused by every consumer that
        shares it (the star join's A builds and projection folds gather
        the SAME message tables)."""
        w = msk = None
        for g, is_bool in self._parts(start, size, cache):
            if is_bool:
                msk = g if msk is None else msk & g
            else:
                w = g if w is None else w * g
        if w is None:
            w = jnp.ones(size, jnp.int32)
        return w if msk is None else jnp.where(msk, w, 0)

    def pos_window(self, start, size):
        """bool window: weight > 0 (factors are nonnegative, so the
        product is positive iff every factor is)."""
        p = None
        for g, is_bool in self._parts(start, size):
            t = g if is_bool else (g > 0)
            p = t if p is None else p & t
        return (jnp.ones(size, bool) if p is None else p)


def _mat(x):
    """Materialize full length — the small-node fallback only."""
    if isinstance(x, _Lazy):
        return x.window(np.int32(0), x.n)
    return x


def _lazy_mul(a, b):
    """Product of None | int32 vector | _Lazy weights (same length);
    stays lazy if either side is."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, _Lazy) or isinstance(b, _Lazy):
        fa = a.factors if isinstance(a, _Lazy) else [("mat", a)]
        fb = b.factors if isinstance(b, _Lazy) else [("mat", b)]
        n = a.n if isinstance(a, _Lazy) else a.shape[0]
        return _Lazy(n, fa + fb)
    return a * b


def _vary(x, axis):
    """Mark a loop-carry init as device-varying inside shard_map (the
    loop body mixes in per-chip data, and carry types must match)."""
    return x if axis is None else jax.lax.pcast(x, axis, to="varying")


def _lazy_any_positive(lz: _Lazy, mask, axis=None):
    """any(weight > 0 [& mask]) over a huge node, window by window
    (OR is idempotent, so the clamped final window may overlap)."""
    n = lz.n
    w_rows = _win_rows()
    if n <= w_rows:
        p = lz.pos_window(np.int32(0), n)
        return jnp.any(p if mask is None else p & mask)
    nw = -(-n // w_rows)

    def body(i, acc):
        start = jnp.minimum(i * w_rows, n - w_rows)
        p = lz.pos_window(start, w_rows)
        if mask is not None:
            p = p & jax.lax.dynamic_slice(mask, (start,), (w_rows,))
        return acc | jnp.any(p)
    return jax.lax.fori_loop(0, nw, body, _vary(jnp.array(False), axis))


def _scatter_add_big(width, key, off, weight, mask, sent, axis=None):
    """zeros(width).at[key + off (masked -> sent)].add(weight) for a
    HUGE key vector, window by window: the scatter's full-length
    broadcast-update / index-select temps (2x 4 GB at 2**30 rows) and
    the masked-index `where` copy all shrink to O(window). weight:
    None | int32 vector | _Lazy — evaluated per window. add is NOT
    idempotent, so the ragged tail re-scatters the LAST w_rows with the
    already-covered head masked to zero weight (live_from), unlike the
    idempotent rewrite the fold/any loops use."""
    n = key.shape[0]
    _win_guard(n)
    w_rows = _win_rows()
    off = np.int32(off)

    def win(start, size, live_from=None):
        k = jax.lax.dynamic_slice(key, (start,), (size,)) + off
        if isinstance(weight, _Lazy):
            w = weight.window(start, size)
        elif weight is None:
            w = jnp.ones(size, jnp.int32)
        else:
            w = jax.lax.dynamic_slice(weight, (start,), (size,))
        if mask is not None:
            m = jax.lax.dynamic_slice(mask, (start,), (size,))
            k = jnp.where(m, k, sent)
            w = jnp.where(m, w, 0)
        if live_from is not None:
            idx = start + jax.lax.broadcasted_iota(jnp.int32, (size,), 0)
            w = jnp.where(idx >= live_from, w, 0)
        return k, w

    n_full = n // w_rows            # n > _BIG_WAVE_ROWS >= w_rows

    def body(i, acc):
        k, w = win(i * w_rows, w_rows)
        return scatter_add_window(acc, k, w)
    acc = jax.lax.fori_loop(0, n_full, body,
                            _vary(jnp.zeros(width, jnp.int32), axis))
    if n_full * w_rows < n:
        k, w = win(np.int32(n - w_rows), w_rows,
                   live_from=np.int32(n_full * w_rows))
        acc = scatter_add_window(acc, k, w)
    return acc


def _fused_node_pass(n, scatters, folds, flag_idx, axis):
    """ONE window loop over a huge node serving every consumer at once:
    message-table scatter builds (the down-pass A slices), exact
    projection folds, and the root NULL flag. Each window slices the
    operands and evaluates every shared lazy gather factor ONCE
    (`_Lazy.window(cache=...)`) — on a star fact node the A build for
    edge 1 gathers edge 2's message table and vice versa, and the
    projection fold gathers BOTH: unfused that is four full gather passes
    over the fact table, fused it is two. The array analog of the
    reference probing all partitions of a bucket in one sweep
    (/root/reference/structs.cpp:111-134 + intermediate.cpp:146-183).

    scatters: [(width, key, off, weight, mask, sent)] — semantics of
        _scatter_add_big (weight: None | vector | _Lazy).
    folds: [(plane, lazy_weight)] — the lazy weight already carries its
        msg_mask factor; returns weighted_partials_segments-style (5, 3)
        folds (decode with combine_weighted_segments).
    flag_idx: folds index whose any(weight > 0) is also wanted (the
        root emptiness bit), or None.
    axis: the mesh axis under shard_map (every window is a slice of this
        chip's shard; the caller psums the returned tables), or None.
    Returns ([A_i], [fold_i], anyp_or_None). Exactness: full windows
    are disjoint; the ragged tail re-runs the LAST w_rows with rows
    already covered masked to zero weight (scatter adds zero, fold
    channels zero via live_from) — the same discipline as
    _scatter_add_big / weighted_partials_big, here sharing one loop.
    """
    _win_guard(n)
    chunk = seg_chunk(n, 1) if folds else 1
    w_rows = max(_win_rows(), chunk)
    n_full = n // w_rows
    m = (n_full * w_rows) // chunk if folds else 0

    def eval_win(start, size, live_rel=None):
        cache = {}
        idx = (None if live_rel is None
               else jax.lax.broadcasted_iota(jnp.int32, (size,), 0))
        sc = []
        for (_width, key, off, weight, mask, sent) in scatters:
            k = _slice_cached(key, start, size, cache) + off
            if isinstance(weight, _Lazy):
                w = weight.window(start, size, cache)
            elif weight is None:
                w = jnp.ones(size, jnp.int32)
            else:
                w = _slice_cached(weight, start, size, cache)
            if mask is not None:
                mk = _slice_cached(mask, start, size, cache)
                k = jnp.where(mk, k, sent)
                w = jnp.where(mk, w, 0)
            if live_rel is not None:
                w = jnp.where(idx >= live_rel, w, 0)
            sc.append((k, w))
        fc, anyp = [], None
        for fi, (plane, lz) in enumerate(folds):
            c = lz.window(start, size, cache)
            if flag_idx == fi:
                cp = c if live_rel is None \
                    else jnp.where(idx >= live_rel, c, 0)
                anyp = jnp.any(cp > 0)
            v = _slice_cached(plane, start, size, cache)
            fc.append(_limbs._channel_sums(v, c, chunk, live_from=live_rel))
        return sc, fc, anyp

    def body(i, carry):
        accA, accF, flg = carry
        start = i * w_rows
        sc, fc, ap = eval_win(start, w_rows)
        accA = tuple(scatter_add_window(a, k, w)
                     for a, (k, w) in zip(accA, sc))
        accF = tuple(jax.lax.dynamic_update_slice(a, cols,
                                                  (0, start // chunk))
                     for a, cols in zip(accF, fc))
        if ap is not None:
            flg = flg | ap
        return (accA, accF, flg)

    accA = tuple(_vary(jnp.zeros(s[0], jnp.int32), axis)
                 for s in scatters)
    accF = tuple(_vary(jnp.zeros((5, m), jnp.int32), axis) for _ in folds)
    flg = _vary(jnp.array(False), axis)
    accA, accF, flg = jax.lax.fori_loop(0, n_full, body, (accA, accF, flg))
    chs = list(accF)
    if n_full * w_rows < n:
        live_rel = np.int32(n_full * w_rows - (n - w_rows))
        sc, fc, ap = eval_win(np.int32(n - w_rows), w_rows,
                              live_rel=live_rel)
        accA = tuple(scatter_add_window(a, k, w)
                     for a, (k, w) in zip(accA, sc))
        chs = [jnp.concatenate([a, cols], axis=1)
               for a, cols in zip(chs, fc)]
        if ap is not None:
            flg = flg | ap

    def finish(ch):
        lo = (ch & 0x7FF).sum(axis=1, dtype=jnp.int32)
        mid = ((ch >> _limbs.SEG_SHIFT) & 0x7FF).sum(axis=1,
                                                     dtype=jnp.int32)
        hi = (ch >> (2 * _limbs.SEG_SHIFT)).sum(axis=1, dtype=jnp.int32)
        return jnp.stack([lo, mid, hi], axis=-1)

    return (list(accA), [finish(ch) for ch in chs],
            flg if flag_idx is not None else None)


def _none_anywhere(x, axis):
    """~any(x), globally across the mesh axis in distributed mode."""
    a = jnp.any(x)
    if axis is None:
        return ~a
    return jax.lax.psum(a.astype(jnp.int32), axis) == 0


def run_ftree_wave(wspecs, cols, vals, axis=None, shards=None):
    """Execute MANY factorized trees in one traced program, batching all
    same-level message scatters/gathers across trees into single
    segmented kernels (per-edge table widths, offsets = running sums).

    wspecs: tuple of (spec, n_cols, n_vals); cols/vals hold every spec's
    operands back to back. Returns (flags, partials) flat, in spec order
    (within a spec: flag_nodes flags, then the M/trailing flag).

    Distributed mode (inside shard_map): `axis` names the mesh axis and
    `shards` gives per-spec (slicer, valid) row-sharding hooks
    (_parse_spec). Each chip scatters only ITS rows into the message
    tables; one psum per level makes them global — the array analog
    of the reference's per-chunk histogram merge
    (/root/reference/structs.cpp:168-173) — and all gathers stay local.
    Flags reduce globally; the returned partials are per-shard (the
    caller psums the stack)."""
    trees = []
    ci = vi = 0
    for qi, (spec, nc, nv) in enumerate(wspecs):
        trees.append(_parse_spec(spec, cols[ci:ci + nc],
                                 vals[vi:vi + nv],
                                 None if shards is None else shards[qi]))
        ci += nc
        vi += nv

    # ---- up pass, level-batched across trees ----
    # Per level, every participating edge owns a width-sized slice of ONE
    # concatenated table (offsets = running sum of edge widths): scatter
    # edges first (one scatter builds them all), precomputed bincounts
    # appended after. Both key columns' codes fit the edge width by
    # construction, so no index can leave its slice.
    maxh = max((h for t in trees for h in t.by_height), default=0)
    for h in range(1, maxh + 1):
        ups = [(t, ei) for t in trees for ei in t.by_height.get(h, ())]
        if not ups:
            continue
        # edges whose CHILD node is huge scatter window by window,
        # each into its own width-sized slot of the level table; the
        # rest batch into one scatter kernel as usual
        sc = [(t, ei) for (t, ei) in ups if t.pre[ei] is None
              and t.ckey[ei].shape[0] <= _BIG_WAVE_ROWS]
        bg = [(t, ei) for (t, ei) in ups if t.pre[ei] is None
              and t.ckey[ei].shape[0] > _BIG_WAVE_ROWS]
        pr = [(t, ei) for (t, ei) in ups if t.pre[ei] is not None]
        offs = {}
        total = 0
        for (t, ei) in sc + bg + pr:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]
        parts = []
        if sc:
            t_sc = sum(t.edges[ei][4] for (t, ei) in sc)
            sent = np.int32(t_sc)        # mode="drop" sentinel
            idxs, ws = [], []
            for (t, ei) in sc:
                _p, c, _pre, _nd, _w = t.edges[ei]
                key = t.ckey[ei]
                off = np.int32(offs[(id(t), ei)])
                w = _mat(t.beta[c])
                mm = t.msg_mask[c]
                if mm is not None:
                    idxs.append(jnp.where(mm, key + off, sent))
                    ws.append(jnp.where(mm, 1, 0) if w is None
                              else jnp.where(mm, w, 0))
                else:
                    idxs.append(key + off)
                    ws.append(jnp.ones(key.shape[0], jnp.int32)
                              if w is None else w)
            B = scatter_add(jnp.zeros(t_sc, jnp.int32), _concat(idxs),
                            _concat(ws))
            if axis is not None:
                B = jax.lax.psum(B, axis)     # local scatters -> global
            parts.append(B)
        # huge-CHILD edges group by (tree, child): one fused window
        # pass per node serves every edge's B build (shared operand
        # slices)
        up_groups: dict = {}
        for (t, ei) in bg:
            up_groups.setdefault((id(t), t.edges[ei][1]), (t, []))[1]\
                .append(ei)
        up_part = {}
        for (_tid, c), (t, eis) in up_groups.items():
            scats = []
            for ei in eis:
                w = t.edges[ei][4]
                scats.append((w, t.ckey[ei], np.int32(0), t.beta[c],
                              t.msg_mask[c], np.int32(w)))
            B_list, _f, _a = _fused_node_pass(
                t.ckey[eis[0]].shape[0], scats, [], None, axis)
            for ei, Bb in zip(eis, B_list):
                if axis is not None:
                    Bb = jax.lax.psum(Bb, axis)
                up_part[(id(t), ei)] = Bb
        parts.extend(up_part[(id(t), ei)] for (t, ei) in bg)
        for (t, ei) in pr:
            parts.append(t.pre[ei])           # already-global bincounts
        mega = _concat(parts)
        gks, meta, resolved = [], [], []
        for (t, ei) in sc + bg + pr:
            off = offs[(id(t), ei)]
            if t.pkey[ei].shape[0] > _BIG_WAVE_ROWS:
                # huge PARENT: defer the gather; boolean trees clamp
                # per window inside the lazy factor
                resolved.append((t, ei, _Lazy.gather(mega, t.pkey[ei],
                                                     off, t.boolean)))
                continue
            gks.append(t.pkey[ei] + np.int32(off))
            meta.append((t, ei, t.pkey[ei].shape[0]))
        g = table_gather(mega, _concat(gks)) if gks else None
        o = 0
        for (t, ei, n) in meta:
            cv = g[o:o + n]
            o += n
            if t.boolean:
                cv = (cv > 0).astype(jnp.int32)
            resolved.append((t, ei, cv))
        for (t, ei, cv) in resolved:
            t.contrib[ei] = cv
            p = t.edges[ei][0]
            t.beta[p] = _lazy_mul(t.beta[p], cv)

    # ---- down pass, level-batched (top-down depths) ----
    maxd = max((d for t in trees for d in t.by_depth), default=-1)
    for d in range(0, maxd + 1):
        downs = [(t, ei) for t in trees for ei in t.by_depth.get(d, ())]
        if not downs:
            continue
        # edges whose PARENT node is huge build their A slice window by
        # window (the scatter weight — alpha[p] times the sibling
        # contribs, a product of huge lazy gathers on a star fact node —
        # is evaluated per window, never materialized)
        sm = [(t, ei) for (t, ei) in downs
              if t.pkey[ei].shape[0] <= _BIG_WAVE_ROWS]
        bg = [(t, ei) for (t, ei) in downs
              if t.pkey[ei].shape[0] > _BIG_WAVE_ROWS]
        offs = {}
        total = 0
        for (t, ei) in sm + bg:
            offs[(id(t), ei)] = total
            total += t.edges[ei][4]

        def down_weight(t, ei):
            p = t.edges[ei][0]
            w = t.alpha[p]
            for ej in t.children[p]:
                if ej != ei:
                    w = _lazy_mul(w, t.contrib[ej])
            return w

        parts = []
        if sm:
            t_sm = sum(t.edges[ei][4] for (t, ei) in sm)
            sent = np.int32(t_sm)
            idxs, ws = [], []
            for (t, ei) in sm:
                p = t.edges[ei][0]
                w = _mat(down_weight(t, ei))
                key = t.pkey[ei]
                off = np.int32(offs[(id(t), ei)])
                mm = t.msg_mask[p]
                if mm is not None:
                    idxs.append(jnp.where(mm, key + off, sent))
                    ws.append(jnp.where(mm, 1, 0) if w is None
                              else jnp.where(mm, w, 0))
                else:
                    idxs.append(key + off)
                    ws.append(jnp.ones(key.shape[0], jnp.int32)
                              if w is None else w)
            Ab = scatter_add(jnp.zeros(t_sm, jnp.int32), _concat(idxs),
                             _concat(ws))
            if axis is not None:
                Ab = jax.lax.psum(Ab, axis)
            parts.append(Ab)
        # huge-parent edges: ONE fused window pass per (tree, parent)
        # builds all of the node's A slices, folds its projections, and
        # emits its NULL flag, sharing every per-window gather factor
        # (_fused_node_pass) — a star fact's sibling-contrib gathers and
        # its projection-weight gathers are the same tables
        groups: dict = {}
        for (t, ei) in bg:
            groups.setdefault((id(t), t.edges[ei][0]), (t, []))[1]\
                .append(ei)
        part_of = {}
        for (_tid, p), (t, eis) in groups.items():
            n_node = t.pkey[eis[0]].shape[0]
            scats = []
            for ei in eis:
                w_edge = t.edges[ei][4]
                scats.append((w_edge, t.pkey[ei], np.int32(0),
                              down_weight(t, ei), t.msg_mask[p],
                              np.int32(w_edge)))
            folds, fold_pi, flag_idx = [], [], None
            for pi, ((i,), plane) in enumerate(zip(t.projs, t.planes)):
                if i != p or pi in t.done_folds:
                    continue
                m_ = _lazy_mul(t.beta[i], t.alpha[i])
                if not isinstance(m_, _Lazy):
                    continue
                if (i == t.root and t.tnode is None and flag_idx is None
                        and t.msg_mask[i] is t.mask[i]):
                    flag_idx = len(folds)
                folds.append((plane, m_.with_mask(t.msg_mask[i])))
                fold_pi.append(pi)
            A_list, fold_list, anyp = _fused_node_pass(
                n_node, scats, folds, flag_idx, axis)
            for ei, Ah in zip(eis, A_list):
                if axis is not None:
                    Ah = jax.lax.psum(Ah, axis)
                part_of[(id(t), ei)] = Ah
            for pi, f in zip(fold_pi, fold_list):
                t.done_folds[pi] = f
            if anyp is not None:
                t.done_flag = anyp
        parts.extend(part_of[(id(t), ei)] for (t, ei) in bg)
        A = _concat(parts)
        gks, meta = [], []
        for (t, ei) in sm + bg:
            off = offs[(id(t), ei)]
            if t.ckey[ei].shape[0] > _BIG_WAVE_ROWS:
                t.alpha[t.edges[ei][1]] = _Lazy.gather(
                    A, t.ckey[ei], off, t.boolean)
                continue
            gks.append(t.ckey[ei] + np.int32(off))
            meta.append((t, ei, t.ckey[ei].shape[0]))
        g = table_gather(A, _concat(gks)) if gks else None
        o = 0
        for (t, ei, n) in meta:
            t.alpha[t.edges[ei][1]] = g[o:o + n]
            o += n

    # ---- flags + sums per tree, emitted in spec order ----
    flags, outs = [], []
    for t in trees:
        mask, msg_mask = t.mask, t.msg_mask
        # the tree's projection folds, built BEFORE the flags so a lazy
        # root flag can fuse into the root projection's fold loop
        # (root_fold = outs index whose any(weight > 0) IS the flag:
        # alpha[root] is always None, so that fold's weight is exactly
        # beta[root] masked by msg_mask[root] — equal to the flag's
        # beta > 0 & mask when no trailing selection retouched the root)
        # nodes with SEVERAL pending lazy folds (a u64 column's 16-bit
        # planes, or several projected columns of one huge node) fold in
        # one fused window pass sharing the weight-product gathers,
        # instead of one weighted_partials_big loop per plane
        by_node: dict = {}
        for pi, ((i,), plane) in enumerate(zip(t.projs, t.planes)):
            if pi in t.done_folds:
                continue
            m = _lazy_mul(t.beta[i], t.alpha[i])
            if isinstance(m, _Lazy):
                by_node.setdefault(i, []).append((pi, plane, m))
        for i, lst in by_node.items():
            if len(lst) < 2:
                # a single lazy fold goes through weighted_partials_big
                # below
                continue
            flag_idx = (0 if (i == t.root and t.tnode is None
                              and t.done_flag is None
                              and msg_mask[i] is mask[i]) else None)
            _al, fold_list, anyp = _fused_node_pass(
                lst[0][1].shape[0], [],
                [(plane, m.with_mask(msg_mask[i])) for (_pi, plane, m) in lst],
                flag_idx, axis)
            for (pi, _plane, _m), f in zip(lst, fold_list):
                t.done_folds[pi] = f
            if anyp is not None:
                t.done_flag = anyp

        tree_outs, root_fold = [], None
        for pi, ((i,), plane) in enumerate(zip(t.projs, t.planes)):
            if pi in t.done_folds:
                # already folded inside a fused window loop
                # (_fused_node_pass) — zero extra passes
                tree_outs.append(("done", t.done_folds[pi]))
                continue
            m = _lazy_mul(t.beta[i], t.alpha[i])
            n = plane.shape[0]
            if isinstance(m, _Lazy):
                # folds window by window; the mask (every distributed
                # shard carries a validity mask) becomes a lazy factor,
                # applied window by window too
                if (i == t.root and t.tnode is None and root_fold is None
                        and msg_mask[i] is mask[i]):
                    root_fold = len(outs) + len(tree_outs)
                tree_outs.append((plane, m.with_mask(msg_mask[i])))
                continue
            if m is None:
                w = (jnp.ones(n, jnp.int32) if msg_mask[i] is None
                     else msg_mask[i].astype(jnp.int32))
            else:
                w = (m if msg_mask[i] is None
                     else jnp.where(msg_mask[i], m, 0))
            tree_outs.append((plane, w))
        flags.extend(_none_anywhere(mask[i], axis) for i in t.flag_nodes)
        if t.root >= 0 and t.tnode is None:
            br, mr = t.beta[t.root], mask[t.root]
            if t.done_flag is not None:
                # emitted by the fused down-pass window loop
                flags.append(_none_anywhere(t.done_flag, axis))
            elif isinstance(br, _Lazy):
                if root_fold is not None:
                    # fused: the fold loop emits any(weight > 0) for
                    # free — zero extra passes over the huge node
                    flags.append(("from_fold", root_fold))
                else:
                    # any(weight > 0 & mask) without materializing the
                    # lazy product — windowed OR, O(window) memory
                    # instead of O(rows); any number of star edges
                    flags.append(_none_anywhere(
                        _lazy_any_positive(br, mr, axis), axis))
            elif br is None:
                flags.append(jnp.array(False) if mr is None
                             else _none_anywhere(mr, axis))
            elif mr is None:
                flags.append(_none_anywhere(br > 0, axis))
            else:
                flags.append(_none_anywhere(mr & (br > 0), axis))
        elif t.tnode is not None:
            # NULL gate from the PRE-selection rows. part[r] == row r of
            # the trailing node participates in the joined multiset
            # before the trailing selection (alpha/beta are messages
            # from the REST of the tree — they never include this node's
            # own masks). For a cross-node gate (trailing fusion) the
            # two sides participate independently: this spec's tree is
            # the PRE-fusion tree, so each side's alpha/beta already
            # exclude the trailing equality.
            def _participates(node, n_rows):
                p = jnp.ones(n_rows, bool)
                if mask[node] is not None:
                    p &= mask[node]
                if t.beta[node] is not None:
                    p &= _mat(t.beta[node]) > 0
                if t.alpha[node] is not None:
                    p &= _mat(t.alpha[node]) > 0
                return p
            part = _participates(t.tnode, t.tsel_a.shape[0])
            part_b = (part if t.tnode_b is None
                      else _participates(t.tnode_b, t.tsel_b.shape[0]))
            if t.tborn:
                # join-born (rewritten case-3 edge): NULL iff its PAIR
                # SET is empty (oracle.py:133-142) <=> no participating
                # row's left class value equals any participating row's
                # right value — a support-intersection test over one
                # dense width-sized table (made global by psum in dist
                # mode: a value may participate on one chip and match on
                # another)
                W = t.twidth
                supp = jnp.zeros(W, jnp.int32).at[
                    jnp.where(part, t.tsel_a, np.int32(W))].max(
                    part.astype(jnp.int32), mode="drop")
                if axis is not None:
                    supp = jax.lax.psum(supp, axis)
                flags.append(_none_anywhere((supp[t.tsel_b] > 0) & part_b,
                                            axis))
            else:
                # native same-slot predicate: never NULLs by itself
                # (Query.cpp:168-170) — NULL iff some JOIN emptied,
                # i.e. the pre-selection multiset is empty
                flags.append(_none_anywhere(part, axis))
        outs.extend(tree_outs)

    # every projection folds through ONE segment-batched reduction:
    # segments concatenate with zero-gap padding to chunk multiples
    # (zero weight == dead row, so gaps contribute nothing); the chunk
    # size adapts to the wave's total rows (utils/limbs.py:seg_chunk) so
    # the fold stays exact to ~2**35 rows. HUGE waves (> 2**28 rows)
    # skip the concatenation — it would copy 2x the wave's bytes, the
    # difference between fitting one chip's HBM at 2**30 rows and not —
    # and fold each projection in place (weighted_partials_big: windowed
    # fori_loop reads straight out of the operands).
    parts = ()
    if outs:
        total = sum(plane.shape[0] for plane, _w in outs
                    if not isinstance(plane, str))
        if (total > _BIG_WAVE_ROWS
                or any(isinstance(w, _Lazy) for _, w in outs)
                or any(isinstance(p, str) for p, _w in outs)):
            want_any = {f[1] for f in flags if isinstance(f, tuple)}
            folds, anyp = [], {}
            for oi, (plane, w) in enumerate(outs):
                if isinstance(plane, str):       # ("done", fused fold)
                    folds.append(w)
                elif not isinstance(w, _Lazy):
                    folds.append(weighted_partials_big(plane, w,
                                                       vary_axis=axis))
                elif oi in want_any:
                    f, ap = weighted_partials_big(
                        plane, weight_fn=w.window, vary_axis=axis,
                        also_any_positive=True)
                    folds.append(f)
                    anyp[oi] = ap
                else:
                    folds.append(weighted_partials_big(
                        plane, weight_fn=w.window, vary_axis=axis))
            flags = [(_none_anywhere(anyp[f[1]], axis)
                      if isinstance(f, tuple) else f) for f in flags]
            parts = (jnp.stack(folds),)
            return tuple(flags), parts
        cseg = seg_chunk(total, len(outs))
        gap = jnp.zeros(cseg, jnp.int32)
        vs, ws, seg_ids = [], [], []
        for si, (plane, w) in enumerate(outs):
            n = plane.shape[0]
            pad = -n % cseg
            vs.append(plane)
            ws.append(w)
            if pad:
                vs.append(gap[:pad])
                ws.append(gap[:pad])
            seg_ids.extend([si] * ((n + pad) // cseg))
        parts = (weighted_partials_segments(
            _concat(vs), _concat(ws),
            np.asarray(seg_ids, np.int32), len(outs), chunk=cseg),)
    return tuple(flags), parts


def run_ftree(spec, cols, vals):
    """Execute one factorized tree (a single-spec wave). Returns
    (flags, partials): one bool flag per flag_node plus the M-emptiness
    flag, and partials = a 1-tuple holding ONE (n_projs, 5, 3) stack of
    SEG_SHIFT-piece weighted folds (weighted_partials_segments layout —
    decode each row with utils/limbs.py:combine_weighted_segments).
    Traced inline under the fused stage program (ops/stage.py)."""
    return run_ftree_wave(((spec, len(cols), len(vals)),),
                          tuple(cols), tuple(vals))

