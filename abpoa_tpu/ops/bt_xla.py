"""Device-side backtrack over DP planes (pure lax, vmapped): the walk half
of the XLA end.

Replicates the reference's in-matrix backtrack exactly — operator priority
M -> D(E) -> I(F) with the indel_first first-step preference and the cur_op
live-operator bitmask (ref src/simd_abpoa_align.c:109-429, oracle twin:
align/engine_np.py _backtrack_{lg,ag,cg}) — but emits a packed step stream
on device, so only O(path) int32s leave the device instead of the O(R*W)
score planes. ``dp_bt_batch`` runs ops/dp_xla's sweep and this walk in one
jit and returns the same (misc, steps) pair as the banded kernel
(ops/dp_band.py). Global and extend modes only: local mode stops on a zero
cell, which the host backtrack (engine_jax._backtrack_from_planes) does.

Each step is one packed int32:  op(2 bits) | dp_row(12) | query_col(18).
The host replays the stream through cigar.push_cigar (same merging rules),
wraps it with the head/tail insertions of _bt_common_start/_bt_finish, and
computes n_aln/n_matched.

Out-of-tile plane reads return 0, matching the zero-residue planes of the
XLA/oracle engines (fresh-arena semantics validated against the goldens).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import LINEAR_GAP, CONVEX_GAP
from .layout import (M_BEST, M_BI, M_BJ, M_CELLS, M_NSTEPS, M_FAIL, M_ENDI,
                     M_ENDJ, M_NMISC)

M_OP, E1_OP, E2_OP = 0x1, 0x2, 0x4
F1_OP, F2_OP = 0x8, 0x10
E_OP, F_OP, ALL_OP = 0x6, 0x18, 0x1F


class BTConfig(NamedTuple):
    gap_mode: int
    R: int
    WB: int      # plane width (the full padded query width W)
    P: int
    LMAX: int


def _mk_slab(cfg, planes):
    """planes: [R, 5, WB] (H,E1,E2,F1,F2 packed). One dynamic_slice per
    (row, column-pair) access: returns the 5 plane values at column j and
    at column j-1 (0 outside the plane, matching zero-residue planes)."""
    WB = cfg.WB

    def slab(i, j):
        lc = j
        s0 = jnp.clip(lc - 1, 0, WB - 2)
        sl = jax.lax.dynamic_slice(planes, (i, 0, s0), (1, 5, 2))[0]
        i_j = jnp.clip(lc - s0, 0, 1)
        i_j1 = jnp.clip(lc - 1 - s0, 0, 1)
        vj = jnp.where((lc >= 0) & (lc < WB),
                       jnp.where(i_j == 1, sl[:, 1], sl[:, 0]), 0)
        vj1 = jnp.where((lc - 1 >= 0) & (lc - 1 < WB),
                        jnp.where(i_j1 == 1, sl[:, 1], sl[:, 0]), 0)
        return vj, vj1
    return slab


def _first_true(conds):
    """Index of the first true cond (static list), -1 if none."""
    idx = jnp.int32(-1)
    for k in reversed(range(len(conds))):
        idx = jnp.where(conds[k], jnp.int32(k), idx)
    return idx


def backtrack_one(cfg: BTConfig, planes, dp_beg, dp_end, pre_idx, pre_n,
                  bases, qcodes, mat, best_i, best_j, e1, oe1, e2, oe2):
    """One instance. planes: [R, 5, W] packed (H,E1,E2,F1,F2), full width.
    dp_beg/dp_end are the per-row band bounds for in-band gating (ref
    engine_np._in_band). pre_idx is [R*P]. Returns (steps[LMAX] packed
    i32, n_steps, fail, end_i, end_j): the stream in push order (reverse
    alignment order)."""
    gm = cfg.gap_mode
    slab = _mk_slab(cfg, planes)

    def in_band(pre, col):
        return (dp_beg[pre] <= col) & (col <= dp_end[pre])

    def score(i, j):
        # mat[base_i, q[j-1]]
        return mat[bases[i], qcodes[j - 1]]

    def push(st, op, i, j):
        steps, n = st
        enc = op | (i << 2) | (j << 14)
        return steps.at[n].set(enc), n + 1

    def body(state):
        i, j, cur_op, indel_first, steps, n, fail, done = state
        vj, vj1 = slab(i, j)
        hij, e1ij, e2ij, f1ij, f2ij = vj[0], vj[1], vj[2], vj[3], vj[4]
        h_prev, f1prev, f2prev = vj1[0], vj1[3], vj1[4]
        s = score(i, j)

        # --- per-pred slab reads (one fused gather each) ---
        pre_vj = []
        pre_vj1 = []
        preds = []
        for p in range(cfg.P):
            pre = pre_idx[i * cfg.P + p]
            preds.append(pre)
            pvj, pvj1 = slab(pre, j)
            pre_vj.append(pvj)
            pre_vj1.append(pvj1)

        # --- candidate: M step to pred p (needs H[pre][j-1]+s == H[i][j])
        m_hits = []
        for p in range(cfg.P):
            pre = preds[p]
            ok = (p < pre_n[i]) & in_band(pre, j - 1)
            m_hits.append(ok & (pre_vj1[p][0] + s == hij))
        m_pick = _first_true(m_hits)
        m_possible = m_pick >= 0

        # --- candidate: E (deletion) steps, pred-major, E1 then E2
        e_conds = []
        e_newop = []
        e_pred = []
        for p in range(cfg.P):
            pre = preds[p]
            okp = (p < pre_n[i]) & in_band(pre, j)
            if gm != LINEAR_GAP:
                e1pre = pre_vj[p][1]
                hpre = pre_vj[p][0]
                hit_m = (cur_op & M_OP > 0) & (hij == e1pre)
                hit_x = (cur_op & M_OP == 0) & (e1ij == e1pre - e1)
                hit1 = okp & (cur_op & E1_OP > 0) & (hit_m | hit_x)
                op1 = jnp.where(hpre - oe1 == e1pre,
                                jnp.int32(M_OP | F_OP), jnp.int32(E1_OP))
                e_conds.append(hit1)
                e_newop.append(op1)
                e_pred.append(pre)
                if gm == CONVEX_GAP:
                    e2pre = pre_vj[p][2]
                    hit_m2 = (cur_op & M_OP > 0) & (hij == e2pre)
                    hit_x2 = (cur_op & M_OP == 0) & (e2ij == e2pre - e2)
                    hit2 = okp & (cur_op & E2_OP > 0) & (hit_m2 | hit_x2)
                    op2 = jnp.where(hpre - oe2 == e2pre,
                                    jnp.int32(M_OP | F_OP),
                                    jnp.int32(E2_OP))
                    e_conds.append(hit2)
                    e_newop.append(op2)
                    e_pred.append(pre)
            else:
                hit = okp & (pre_vj[p][0] - e1 == hij)
                e_conds.append(hit)
                e_newop.append(jnp.int32(ALL_OP))
                e_pred.append(pre)
        e_pick = _first_true(e_conds)
        e_possible = e_pick >= 0
        e_pred_sel = jnp.int32(0)
        e_op_sel = jnp.int32(ALL_OP)
        for k in range(len(e_conds)):
            sel = e_pick == k
            e_pred_sel = jnp.where(sel, e_pred[k], e_pred_sel)
            e_op_sel = jnp.where(sel, e_newop[k], e_op_sel)

        # --- candidate: F (insertion) step
        if gm == LINEAR_GAP:
            f_possible = h_prev - e1 == hij
            f_op_sel = jnp.int32(ALL_OP)
        else:
            f1_open = h_prev - oe1 == f1ij
            f1_ext = f1prev - e1 == f1ij
            f1_gate = jnp.where(cur_op & M_OP > 0, hij == f1ij, True)
            hit_f1 = (cur_op & F1_OP > 0) & f1_gate & (f1_open | f1_ext)
            op_f1 = jnp.where(f1_open, jnp.int32(M_OP | E_OP),
                              jnp.int32(F1_OP))
            if gm == CONVEX_GAP:
                f2_open = h_prev - oe2 == f2ij
                f2_ext = f2prev - e2 == f2ij
                f2_gate = jnp.where(cur_op & M_OP > 0, hij == f2ij, True)
                hit_f2 = (cur_op & F2_OP > 0) & f2_gate \
                    & (f2_open | f2_ext)
                op_f2 = jnp.where(f2_open, jnp.int32(M_OP | E_OP),
                                  jnp.int32(F2_OP))
            else:
                hit_f2 = jnp.bool_(False)
                op_f2 = jnp.int32(ALL_OP)
            f_possible = hit_f1 | hit_f2
            f_op_sel = jnp.where(hit_f1, op_f1, op_f2)

        # --- priority resolution (ref :109-429 order) ---
        use_m1 = (cur_op & M_OP > 0) & jnp.logical_not(indel_first) \
            & m_possible
        use_e = jnp.logical_not(use_m1) & (cur_op & E_OP > 0) & e_possible
        if gm == LINEAR_GAP:
            use_e = jnp.logical_not(use_m1) & e_possible
        use_f = (jnp.logical_not(use_m1) & jnp.logical_not(use_e)
                 & f_possible)
        if gm != LINEAR_GAP:
            use_f = use_f & (cur_op & F_OP > 0)
        use_m2 = (jnp.logical_not(use_m1) & jnp.logical_not(use_e)
                  & jnp.logical_not(use_f) & (cur_op & M_OP > 0)
                  & indel_first & m_possible)
        if gm == LINEAR_GAP:
            use_m2 = (jnp.logical_not(use_m1) & jnp.logical_not(use_e)
                      & jnp.logical_not(use_f) & indel_first & m_possible)
        any_hit = use_m1 | use_e | use_f | use_m2
        fail = fail | jnp.logical_not(any_hit)

        use_m = use_m1 | use_m2
        m_pred = jnp.int32(0)
        for p in range(cfg.P):
            m_pred = jnp.where(m_pick == p, preds[p], m_pred)

        op_code = jnp.where(use_m, 0, jnp.where(use_e, 2, 1))  # M/D/I
        steps, n = push((steps, n), op_code, i, j)
        n = jnp.where(any_hit, n, n - 1)  # drop push on fail

        new_i = jnp.where(use_m, m_pred, jnp.where(use_e, e_pred_sel, i))
        new_j = jnp.where(use_m | use_f, j - 1, j)
        new_cur = jnp.where(use_m, jnp.int32(ALL_OP),
                            jnp.where(use_e, e_op_sel,
                                      jnp.where(use_f, f_op_sel, cur_op)))
        new_if = jnp.where(use_m, jnp.bool_(False), indel_first)
        done = fail | (new_i <= 0) | (new_j <= 0)
        return (new_i, new_j, new_cur, new_if, steps, n, fail, done)

    def cond(state):
        i, j, cur_op, indel_first, steps, n, fail, done = state
        return jnp.logical_not(done) & (n < cfg.LMAX)

    steps0 = jnp.zeros(cfg.LMAX, jnp.int32)
    init = (best_i, best_j, jnp.int32(ALL_OP), jnp.bool_(True), steps0,
            jnp.int32(0), jnp.bool_(False),
            (best_i <= 0) | (best_j <= 0))
    i, j, cur_op, indel_first, steps, n, fail, done = jax.lax.while_loop(
        cond, body, init)
    return steps, n, fail, i, j


@partial(jax.jit, static_argnums=(0, 1))
def dp_bt_batch(dp_cfg, lmax: int, inp):
    """The XLA end: dp_xla's banded sweep and the device walk in one jit.
    inp is a batched dp_xla.DPInputs; returns (misc [B, M_NMISC], steps
    [B, lmax]) in the banded kernel's layout, so only those leave the
    device. Global/extend modes (see module docstring)."""
    from .dp_xla import banded_poa_dp
    i32 = jnp.int32
    cfg = BTConfig(gap_mode=dp_cfg.gap_mode, R=dp_cfg.R, WB=dp_cfg.W,
                   P=dp_cfg.P, LMAX=lmax)

    def one(x):
        out = banded_poa_dp(dp_cfg, x)
        planes = jnp.stack([out.H, out.E1, out.E2, out.F1, out.F2], axis=1)
        qcodes = x.qcol[1:]
        steps, n, fail, ei, ej = backtrack_one(
            cfg, planes, out.dp_beg, out.dp_end, x.pre_idx.reshape(-1),
            x.pre_n, x.bases, qcodes, x.mat, out.best_i, out.best_j,
            x.e1, x.oe1, x.e2, x.oe2)
        misc = jnp.zeros(M_NMISC, i32)
        for slot, v in ((M_BEST, out.best_score), (M_BI, out.best_i),
                        (M_BJ, out.best_j), (M_CELLS, out.n_cells),
                        (M_NSTEPS, n), (M_FAIL, fail), (M_ENDI, ei),
                        (M_ENDJ, ej)):
            misc = misc.at[slot].set(jnp.asarray(v).astype(i32))
        return misc, steps
    return jax.vmap(one)(inp)


def replay_steps(graph, params, query, steps, n_steps, best_i, best_j,
                 end_i, end_j, res, row0=0):
    """Host replay: packed device steps -> reference cigar list + res
    fields, vectorized (push_cigar merging applies only to runs of CINS —
    M/X and D entries are appended one per step; ref abpoa_align.h:54-73).
    row0: topo index of dp row 0 (subgraph windows)."""
    from ..cigar import CMATCH, CINS, CDEL
    qlen = len(query)
    i2n = np.asarray(graph.index_to_node_id, dtype=np.int64)[row0:]
    n = int(n_steps)
    enc = np.asarray(steps[:n])
    ops = enc & 0x3
    rows = (enc >> 2) & 0xFFF
    cols = enc >> 14
    nids = i2n[rows] if n else np.zeros(0, np.int64)
    cigar: list = []
    if best_j < qlen:
        cigar.append((CINS, qlen - 1, qlen - best_j))
    if n:
        # counters (M: aln+match; I: aln)
        m_mask = ops == 0
        res.n_aln_bases += int(m_mask.sum() + (ops == 1).sum())
        if m_mask.any():
            mrows = nids[m_mask]
            # CSR bases, not graph.node[...]: the Node view would
            # re-materialize the native store once per round
            bases = graph.build_csr()["bases"][mrows].astype(np.int64)
            res.n_matched_bases += int(
                (bases == np.asarray(query)[cols[m_mask] - 1]).sum())
        # run-length groups over the op stream
        brk = np.nonzero(np.diff(ops))[0] + 1
        starts = np.concatenate(([0], brk))
        ends = np.concatenate((brk, [n]))
        for s0, s1 in zip(starts, ends):
            op = int(ops[s0])
            if op == 0:    # one CMATCH entry per column
                cigar.extend(zip([CMATCH] * (s1 - s0),
                                 nids[s0:s1].tolist(),
                                 (cols[s0:s1] - 1).tolist()))
            elif op == 2:  # one CDEL entry per step (CDEL never merges)
                cigar.extend(zip([CDEL] * (s1 - s0), nids[s0:s1].tolist(),
                                 [1] * (s1 - s0)))
            else:          # CINS runs merge, keeping the first pushed qid
                if cigar and cigar[-1][0] == CINS:
                    last = cigar[-1]
                    cigar[-1] = (CINS, last[1], last[2] + (s1 - s0))
                else:
                    cigar.append((CINS, int(cols[s0]) - 1, s1 - s0))
    if int(end_j) > 0:
        if cigar and cigar[-1][0] == CINS:
            last = cigar[-1]
            cigar[-1] = (CINS, last[1], last[2] + int(end_j))
        else:
            cigar.append((CINS, int(end_j) - 1, int(end_j)))
    if not params.rev_cigar:
        cigar.reverse()
    res.cigar = cigar
    res.node_e = int(i2n[int(best_i)])
    res.query_e = int(best_j) - 1
    start_i = int(rows[n - 1]) if n else int(best_i)
    start_j = int(cols[n - 1]) if n else int(best_j)
    res.node_s = int(i2n[start_i])
    res.query_s = start_j - 1
    return res
