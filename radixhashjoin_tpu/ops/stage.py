"""Fused stage runner: one compiled program per readback boundary,
covering a GROUP of queries at once.

Every dispatch and host readback has a fixed host-side cost, which
dominates the workload once the math is fast. The batch executor therefore compiles queries into STAGES — maximal runs of
operators between output-shape readbacks (only a non-terminal join's
expansion size needs the host) — and packs many queries' stages into a
single XLA program. The whole 50-query golden workload executes in a
handful of dispatches:

  round 0: every query's filters + first join (probe or fused terminal)
  sync    : one stacked readback of all pending expansion sizes
  round k: expansion + next join ... until no probes remain
  sweep   : one readback of all NULL flags + SUM partials

The plan is a static tuple of op descriptors; the jitted ops from
filter/chain/backend/terminal inline under the outer jit, so XLA sees
(and fuses across) everything. Dense-backend only — the sort backend
keeps the per-op path.

Op descriptors (all fields static; slot indices are GLOBAL across the
group's concatenated live arrays; `mi` indexes the group's mats; `pi`
indexes the probes consumed by expansions):
  ("ffull", slot, opcode, bucket)        first filter on a pristine slot
  ("flive", slot, opcode)                subsequent filter
  ("eqrows", mi, slot)                   fresh same-slot predicate (wipes)
  ("eqmat", mi, r1, r2, null_flag)       case 3 / joined same-slot filter
  ("probe1", s1, s2)                     case-1 probe (emits a probe)
  ("probe2", mi, full_row, fresh)        case-2 probe (emits a probe)
  ("expand_pair", pi, mi, s1, s2, out)   case-1 expansion into mats[mi]
  ("expand_attach", pi, mi, fresh, out)  case-2 expansion of mats[mi]
  ("spec_pair", mi, s1, s2, out)         speculative case-1 probe+expand
      at a stats-estimated size in the SAME program (no readback); emits
      a NULL flag (total==0) and a spec ok-flag (total fits `out`)
  ("spec_attach", mi, full_row, fresh, out)  speculative case-2 ditto
  ("terminal", mi, ex_kind, (fresh_slot, rows_slot), full_row,
   proj_specs, n_cols, mult_rows)        fused terminal join + SUMs;
      mult_rows (tuple | None) multiply into the weights when middle
      attaches were deferred
  ("project", mi, row)                   non-terminal projection (limb sum)
  ("defer_attach", mi, fresh, src)       deferred middle attach (any
      depth, any count): no expansion — rows gain a `mult` row (match
      counts) and an `lv` row (full-side values), zero-mult rows compact
      away. src is ("mat", full_row) | ("rows", slot).
  ("project_defer", mi, full_row, tf_slot, lv_row, d_slot, excl, ch)
      deferred-slot projection at a terminal: T-table sum weighted by
      terminal counts x the OTHER deferred multiplicities (excl rows);
      ch is the static fresh-side channel plan (terminal.channel_spec)
  ("project_defer_nt", mi, lv_row, d_slot, excl, ch)
      deferred-slot projection with no terminal join
  ("project_w", mi, row, mult_rows)      projection weighted by deferred
      multiplicities (pipeline ended on a row-filter join)
  ("ftree", spec, n_cols, n_vals)        ENTIRE tree-shaped query,
      factorized (ops/factorized.py): filters are boolean masks (no
      live-set compaction at all), one up/down count-message pass
      replaces every probe/expansion/terminal; emits per-filtered-node
      NULL flags + the M-emptiness flag + per-plane weighted folds
  ("ftree_wave", wspecs, n_cols, n_vals) MANY factorized queries in one
      op (wspecs = tuple of (spec, n_cols, n_vals)): all same-level
      message scatters/gathers merge into single segmented-domain
      kernels across queries — O(tree height) kernels instead of
      O(queries x edges)

Column operands arrive in `cols` in plan order; filter constants in
`vals`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .aggregate import _gather_partials
from .backend import (_expand_attach_dense, _expand_pair_dense,
                      _probe_matrix_dense, _probe_rows_dense)
from .chain import eq_filter_matrix, eq_filter_rows
from .compact import compact_mask_positions
from .factorized import run_ftree, run_ftree_wave
from .filter import filter_full, filter_live
from .join_dense import dense_any_common
from .terminal import (_dense_counts, _fresh_sum_weighted,
                       terminal_join_and_project)
from ..utils.limbs import weighted_partials


def touched_state(plan):
    """Static analysis of a plan: (slots written, mat indices written).
    Only these come back as stage outputs — pass-through state would
    otherwise be materialized as program outputs (wasted HBM traffic)."""
    slots = sorted({op[1] for op in plan if op[0] in ("ffull", "flive")})
    mats = sorted({op[1] for op in plan
                   if op[0] in ("eqrows", "eqmat", "defer_attach",
                                "spec_pair", "spec_attach")} |
                  {op[2] for op in plan
                   if op[0] in ("expand_pair", "expand_attach")})
    return tuple(slots), tuple(mats)


@partial(jax.jit, static_argnames=("plan", "domain", "keep_slots",
                                   "keep_mats", "keep_probes"))
def run_stage(live_rows, live_cnt, mats, icounts, probes, cols, vals,
              plan, domain, keep_slots=(), keep_mats=(), keep_probes=()):
    """Execute one fused stage for a group of queries.

    Returns (packed, kept live_rows, kept live_cnt, kept mats, kept
    icounts, kept probe states). `packed` is ONE flat int32 vector
    [flags | spec ok-flags | probe totals | partials] — every output
    buffer of a dispatch is one more device->host transfer for the
    host to wait on, so a stage that used to return ~20 arrays returns
    one vector plus only the state a later stage genuinely consumes
    (keep_* are the planner's per-round static keep sets: state survives only for
    queries that emitted a probe and continue next round)."""
    lr = list(live_rows)
    lc = list(live_cnt)
    mats = list(mats)
    ic = list(icounts)
    ci = vi = 0
    flags = []
    partials = []
    probes_out = []
    specs = []

    def _mult_of(mi, rows):
        m = mats[mi][rows[0]]
        for r in rows[1:]:
            m = m * mats[mi][r]
        return m
    for op in plan:
        k = op[0]
        if k == "ffull":
            _, slot, opc, bucket = op
            rows, cnt = filter_full(cols[ci], lc[slot], vals[vi], opc, bucket)
            ci += 1
            vi += 1
            lr[slot], lc[slot] = rows, cnt
            flags.append(cnt == 0)
        elif k == "flive":
            _, slot, opc = op
            rows, cnt = filter_live(lr[slot], lc[slot], cols[ci], vals[vi],
                                    opc)
            ci += 1
            vi += 1
            lr[slot], lc[slot] = rows, cnt
            flags.append(cnt == 0)
        elif k == "eqrows":
            _, mi, slot = op
            rows, cnt = eq_filter_rows(cols[ci], cols[ci + 1], lr[slot],
                                       lc[slot])
            ci += 2
            mats[mi], ic[mi] = rows[None], cnt
        elif k == "eqmat":
            _, mi, r1, r2, null_flag = op
            colA, colB = cols[ci], cols[ci + 1]
            ci += 2
            if null_flag:
                flags.append(~dense_any_common(colA[mats[mi][r1]],
                                               colB[mats[mi][r2]],
                                               ic[mi], domain))
            mats[mi], ic[mi] = eq_filter_matrix(colA, colB, mats[mi], r1, r2,
                                                ic[mi])
        elif k == "probe1":
            _, s1, s2 = op
            probes_out.append(_probe_rows_dense(cols[ci], lr[s1], lc[s1],
                                                cols[ci + 1], lr[s2], lc[s2],
                                                domain))
            ci += 2
        elif k == "probe2":
            _, mi, full_row, fresh = op
            probes_out.append(_probe_matrix_dense(
                cols[ci], mats[mi], np.int32(full_row), ic[mi],
                cols[ci + 1], lr[fresh], lc[fresh], domain))
            ci += 2
        elif k == "expand_pair":
            _, pi, mi, s1, s2, out = op
            mats[mi] = _expand_pair_dense(*probes[pi][:4], lr[s1], lr[s2],
                                          out)
            ic[mi] = probes[pi][4]
        elif k == "expand_attach":
            _, pi, mi, fresh, out = op
            mats[mi] = _expand_attach_dense(*probes[pi][:4], mats[mi],
                                            lr[fresh], out)
            ic[mi] = probes[pi][4]
        elif k == "spec_pair":
            # speculative case-1 expansion: probe + expand at a stats-
            # estimated size inside the SAME program; ok-flag verifies
            _, mi, s1, s2, out = op
            pr = _probe_rows_dense(cols[ci], lr[s1], lc[s1], cols[ci + 1],
                                   lr[s2], lc[s2], domain)
            ci += 2
            total = pr[4]
            mats[mi] = _expand_pair_dense(*pr[:4], lr[s1], lr[s2], out)
            ic[mi] = total
            flags.append(total == 0)
            specs.append((total >= 0) & (total <= out))
        elif k == "spec_attach":
            _, mi, full_row, fresh, out = op
            pr = _probe_matrix_dense(cols[ci], mats[mi], np.int32(full_row),
                                     ic[mi], cols[ci + 1], lr[fresh],
                                     lc[fresh], domain)
            ci += 2
            total = pr[4]
            mats[mi] = _expand_attach_dense(*pr[:4], mats[mi], lr[fresh],
                                            out)
            ic[mi] = total
            flags.append(total == 0)
            specs.append((total >= 0) & (total <= out))
        elif k == "terminal":
            (_, mi, ex_kind, ex_slots, full_row, proj_specs, n_cols,
             mult_rows) = op
            col_full, col_fresh_join = cols[ci], cols[ci + 1]
            fresh_slot, rows_slot = ex_slots
            src = mats[mi] if ex_kind == "mat" else lr[rows_slot]
            cnt = ic[mi] if ex_kind == "mat" else lc[rows_slot]
            pc = tuple(cols[ci + 2:ci + 2 + n_cols])
            ci += 2 + n_cols
            mult = _mult_of(mi, mult_rows) if mult_rows else None
            empty, outs = terminal_join_and_project(
                src, cnt, lr[fresh_slot], lc[fresh_slot], col_full,
                col_fresh_join, pc, (ex_kind, full_row, proj_specs), domain,
                mult=mult)
            flags.append(empty)
            partials.extend(outs)
        elif k == "defer_attach":
            _, mi, fresh, src = op
            col_full, col_fresh_join = cols[ci], cols[ci + 1]
            ci += 2
            if src[0] == "mat":
                lv = col_full[mats[mi][src[1]]]
                cnt = ic[mi]
                base = mats[mi]
            else:
                lv = col_full[lr[src[1]]]
                cnt = lc[src[1]]
                base = lr[src[1]][None]
            counts, lvm = _dense_counts(lv, cnt, col_fresh_join[lr[fresh]],
                                        lc[fresh], domain)
            # empty pair set -> NULL (wrap-proof: the deferred pair count
            # can exceed int32, so sum(counts)==0 would false-trigger)
            flags.append(~jnp.any(counts > 0))
            n = counts.shape[0]
            idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
            keep = (idx < cnt) & (counts > 0)
            pos, ncnt = compact_mask_positions(keep)
            stacked = jnp.concatenate([base, counts[None], lvm[None]],
                                      axis=0)
            mats[mi] = jnp.zeros_like(stacked).at[:, pos].set(stacked,
                                                             mode="drop")
            ic[mi] = ncnt
        elif k == "project_defer":
            _, mi, full_row, tf_slot, lv_row, d_slot, excl, ch = op
            col_full_t, col_join_tf = cols[ci], cols[ci + 1]
            col_join_d, col_proj = cols[ci + 2], cols[ci + 3]
            ci += 4
            counts_t, _ = _dense_counts(col_full_t[mats[mi][full_row]],
                                        ic[mi], col_join_tf[lr[tf_slot]],
                                        lc[tf_slot], domain)
            w = counts_t * _mult_of(mi, excl) if excl else counts_t
            partials.append(_fresh_sum_weighted(
                col_proj, col_join_d, lr[d_slot], lc[d_slot],
                mats[mi][lv_row], w, ic[mi], domain, ch))
        elif k == "project_defer_nt":
            # deferred-slot projection with NO terminal join: weights are
            # the product of the OTHER deferred multiplicities (ones if
            # this is the only deferral)
            _, mi, lv_row, d_slot, excl, ch = op
            col_join_d, col_proj = cols[ci], cols[ci + 1]
            ci += 2
            w = (_mult_of(mi, excl) if excl
                 else jnp.ones(mats[mi].shape[1], jnp.int32))
            partials.append(_fresh_sum_weighted(
                col_proj, col_join_d, lr[d_slot], lc[d_slot],
                mats[mi][lv_row], w, ic[mi], domain, ch))
        elif k == "project_w":
            # intermediate projection weighted by deferred multiplicities
            _, mi, row, mult_rows = op
            partials.append(weighted_partials(
                cols[ci][mats[mi][row]], _mult_of(mi, mult_rows), ic[mi]))
            ci += 1
        elif k == "ftree":
            # whole tree-shaped query, factorized: no materialization,
            # mask-based filters, per-filtered-node NULL flags + the
            # M-emptiness flag + one (5,2) weighted fold per projection
            # plane (ops/factorized.py; flag-only when projs is empty)
            _, spec, n_cols, n_vals = op
            fc = tuple(cols[ci:ci + n_cols])
            fv = tuple(vals[vi:vi + n_vals])
            ci += n_cols
            vi += n_vals
            fflags, outs = run_ftree(spec, fc, fv)
            flags.extend(fflags)
            partials.extend(outs)
        elif k == "ftree_wave":
            # MANY factorized queries with level-batched message kernels
            # (ops/factorized.py:run_ftree_wave); flags/partials arrive
            # in per-query order, exactly as the per-query ops would
            # emit them
            _, wspecs, n_cols, n_vals = op
            fc = tuple(cols[ci:ci + n_cols])
            fv = tuple(vals[vi:vi + n_vals])
            ci += n_cols
            vi += n_vals
            fflags, outs = run_ftree_wave(wspecs, fc, fv)
            flags.extend(fflags)
            partials.extend(outs)
        elif k == "project":
            _, mi, row = op
            partials.append(_gather_partials(cols[ci], mats[mi][row],
                                             ic[mi]))
            ci += 1
        else:  # pragma: no cover
            raise ValueError(op)
    segs = []
    if flags:
        segs.append(jnp.stack(flags).astype(jnp.int32))
    if specs:
        segs.append(jnp.stack(specs).astype(jnp.int32))
    if probes_out:
        segs.append(jnp.stack([p[4] for p in probes_out]))
    segs += [p.reshape(-1) for p in partials]
    packed = jnp.concatenate(segs) if segs else jnp.zeros(0, jnp.int32)
    return (packed,
            tuple(lr[s] for s in keep_slots),
            tuple(lc[s] for s in keep_slots),
            tuple(mats[m] for m in keep_mats),
            tuple(ic[m] for m in keep_mats),
            tuple(probes_out[p][:4] for p in keep_probes))


def part_shape(kind):
    """Static shape of one packed partial, by sum_map kind (see
    utils/limbs.py for the folded layouts)."""
    if kind == "limb":
        return (2, 2)
    if kind == "weighted":
        return (5, 2)
    if kind == "weighted_seg":
        return (5, 3)
    k, ch = kind
    return (len(ch), 2, 2) if k == "fresh" else (len(ch), 5, 2)
