"""Banded POA DP sweep + backtrack walk as one Pallas (Triton) GPU kernel.

One program aligns one instance's query to its DAG: a ``fori_loop`` over
the topological rows inside the kernel, each row a vector of ``WB`` lanes
(the band tile), then the backtrack walk in the same launch. Only ``misc``
and the packed int32 step stream leave the kernel (layout in ops/layout.py).
The math is the row body of ops/dp_xla.py, which is cell-exact against the
oracle (ref src/simd_abpoa_align.c:434-1412):

  * Planes H/E1/E2 and a backtrack-bits plane are ``[B, R, WB]`` int32 in
    device memory. Row t stores its band window [lo_t, lo_t + WB) with
    query column c at lane c mod WB (lo_t = beg_sn(t) * pn); every row uses
    that map, so a predecessor's column c sits at the same lane and merges
    need no alignment. In registers a row is held in window order (lane k
    = column lo_t + k); loads and stores go through the mod-WB map.
  * Band state is pulled: row t's adaptive band comes from the row maxima
    of its predecessors (all swept before t) instead of a scatter to
    successors (ref abpoa_ada_max_i :1274-1282).
  * Backtrack bits: every comparison the reference walk makes (M/E/F hits,
    gap-open bits, first-predecessor picks under both cur_op gates) is baked
    into one int32 per cell during the sweep, so the walk reads one word per
    step and no F plane exists (ref src/abpoa_align.c:64-170, oracle twin
    engine_np._backtrack_*).
  * Shifts of a row (the F prefix max in log steps, the one-column shift of
    H/F for the F bits) go through a small per-program scratch with a block
    barrier between store and shifted load.
  * A row whose band plus guard segment outgrows WB sets M_OVFL; the host
    re-runs that instance on the oracle.

Covers global/extend mode, linear/affine/convex gaps, banded (wb >= 0),
whole graphs (no subgraph row mask), R <= 4096, qlen < 2**17. Local mode,
unbanded runs and subgraph windows take the XLA end (ops/dp_xla.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..params import GLOBAL_MODE, EXTEND_MODE, LINEAR_GAP, CONVEX_GAP
from .layout import (NEG, S_QLEN, S_NROWS, S_W, S_INF, S_REMEND, S_E1,
                     S_O1, S_OE1, S_E2, S_O2, S_OE2, S_ZDROP, S_DPSN,
                     S_NSCAL, M_BEST, M_BI, M_BJ, M_CELLS, M_OVFL,
                     M_NSTEPS, M_FAIL, M_ENDI, M_ENDJ, M_NMISC, BT_M, BT_E1,
                     BT_E2, BT_F1, BT_F2, BT_E, BT_F, BT_ALL, MAX_ROWS,
                     MAX_COLS)

NUM_WARPS = 4              # one program's threads: WB/128 lanes each
BIG = 1 << 29
RM_OK = 1 << 30            # rms word: row max may propagate | (max col + 1)
INVALID_BITS = 15 | (15 << 4) | (15 << 8) | (15 << 14) | (15 << 18)


class BandConfig(NamedTuple):
    """Static kernel configuration; one compiled kernel per value."""
    gap_mode: int
    align_mode: int
    pn: int          # lane-snap width from the 16/32-bit score dispatch
    R: int           # padded row capacity (<= 4096)
    WB: int          # band tile, a power of two >= 128
    Wq: int          # padded query-profile width (> qlen)
    P: int           # padded max in-degree
    m: int           # alphabet size
    use_zdrop: bool
    lmax: int        # step-stream capacity


def pick_wb(params, qlen: int, pn: int) -> int:
    """Band tile: the adaptive band grows beyond 2w when max-pos hints
    spread across branches (up to ~8 pn-segments on the 700 bp fixtures),
    so size generously; outliers raise M_OVFL."""
    w = params.wb + int(params.wf * qlen)
    need = min(4 * w + 8 * pn, qlen + 1 + 2 * pn)
    need = max(need, 4 * pn, 128)
    return 1 << (need - 1).bit_length()


def covers(params, R: int, qlen: int) -> bool:
    """Whether the kernel takes an input of this shape and mode."""
    return (params.wb >= 0
            and params.align_mode in (GLOBAL_MODE, EXTEND_MODE)
            and R <= MAX_ROWS and qlen + 1 < MAX_COLS)


def _e_rows(cfg: BandConfig):
    """Rows of the E1 and E2 planes: one unused row for a gap mode
    without that plane."""
    return (1 if cfg.gap_mode == LINEAR_GAP else cfg.R,
            cfg.R if cfg.gap_mode == CONVEX_GAP else 1)


def instance_bytes(cfg: BandConfig) -> int:
    """Device bytes one instance holds in a call: the H, E1, E2 and bits
    planes, the row vectors, the step stream and the inputs (all int32)."""
    RE1, RE2 = _e_rows(cfg)
    words = ((2 * cfg.R + RE1 + RE2 + 6) * cfg.WB + M_NMISC + cfg.lmax
             + (8 + cfg.P) * cfg.R + 16 + cfg.m * cfg.Wq)
    return 4 * words


def _make_kernel(cfg: BandConfig, interpret: bool):
    pn, R, WB, P, Wq = cfg.pn, cfg.R, cfg.WB, cfg.P, cfg.Wq
    MASK = WB - 1
    LOGWB = WB.bit_length() - 1
    NSEG = WB // pn
    gm = cfg.gap_mode
    lin = gm == LINEAR_GAP
    conv = gm == CONVEX_GAP
    extend = cfg.align_mode == EXTEND_MODE
    i32 = jnp.int32

    def barrier():
        # interpret mode runs the program as one sequential trace
        if not interpret:
            plgpu.debug_barrier()

    def kernel(scal, bases, pre_idx, pre_n, remain, mpl0, mpr0, qp,
               misc_o, steps_o, Hb, E1b, E2b, BTb, begsn, endsn, rms, shf):
        k = jnp.arange(WB, dtype=i32)
        qlen = scal[S_QLEN]
        n_rows = scal[S_NROWS]
        w = scal[S_W]
        inf = scal[S_INF]
        rem_end = scal[S_REMEND]
        e1, o1, oe1 = scal[S_E1], scal[S_O1], scal[S_OE1]
        e2, o2, oe2 = scal[S_E2], scal[S_O2], scal[S_OE2]
        zdrop = scal[S_ZDROP]
        dp_sn = scal[S_DPSN]
        step = [0]   # trace-time ping-pong slot counter

        def shift(vs, d):
            """vs[i][k - d] for k >= d (lane k < d: garbage, mask it)."""
            slot = step[0] & 1
            step[0] += 1
            for n, v in enumerate(vs):
                shf[slot, n, :] = v
            barrier()
            src = jnp.maximum(k - d, 0)
            return [shf[slot, n, src] for n in range(len(vs))]

        def kscan_max(gvs):
            """Inclusive running max along the window (Kogge-Stone)."""
            for s in range(LOGWB):
                d = 1 << s
                shs = shift(gvs, d)
                gvs = [jnp.maximum(g, jnp.where(k >= d, sh, NEG))
                       for g, sh in zip(gvs, shs)]
            return gvs

        # ---------------- first row (ref :553-662) ----------------
        rem0 = remain[0] - rem_end - 1
        end0 = jnp.minimum(qlen, jnp.maximum(0, qlen - rem0) + w)
        end_sn0 = end0 // pn
        begsn[0] = i32(0)
        endsn[0] = end_sn0
        rms[0] = i32(RM_OK | 1)
        ovfl0 = (jnp.minimum(end_sn0 + 1, dp_sn - 1) + 2 > NSEG).astype(i32)
        hi_mask = k // pn <= jnp.minimum(end_sn0 + 1, dp_sn - 1)
        de_mask = k <= (end_sn0 + 1) * pn - 1
        zero = jnp.zeros((WB,), i32)
        if lin:
            Hb[0, :] = jnp.where(de_mask, -e1 * k,
                                 jnp.where(hi_mask, inf, 0))
        else:
            hv = -o1 - e1 * k
            if conv:
                hv = jnp.maximum(hv, -o2 - e2 * k)
            h0 = jnp.where(de_mask & (k >= 1), hv,
                           jnp.where(hi_mask, inf, 0))
            Hb[0, :] = jnp.where(k == 0, 0, h0)
            E1b[0, :] = jnp.where(k == 0, -oe1, jnp.where(hi_mask, inf, 0))
            if conv:
                E2b[0, :] = jnp.where(k == 0, -oe2,
                                      jnp.where(hi_mask, inf, 0))
        barrier()

        # ---------------- row sweep ----------------
        def pred_band(t, p, pv):
            pred = pre_idx[t * P + p]
            pbeg = jnp.where(pv, begsn[pred], BIG)
            pend = jnp.where(pv, endsn[pred], -BIG)
            return pred, pbeg, pend

        def body(t, carry):
            bs, bi, bj, brem, stopped, cells, ovfl = carry
            active = stopped == 0
            npre = pre_n[t]

            # adaptive band pulled from the predecessors' row maxima
            def pull(p, acc):
                mpl, mpr, has_src, min_pb = acc
                pred = pre_idx[t * P + p]
                min_pb = jnp.minimum(min_pb, begsn[pred])
                wv = rms[pred]
                ok = wv >= RM_OK
                v = wv & (RM_OK - 1)
                mpl = jnp.minimum(mpl, jnp.where(ok, v, BIG))
                mpr = jnp.maximum(mpr, jnp.where(ok, v, -BIG))
                has_src = has_src | (pred == 0).astype(i32)
                return mpl, mpr, has_src, min_pb
            mpl, mpr, has_src, min_pb = jax.lax.fori_loop(
                0, npre, pull, (i32(BIG), i32(-BIG), i32(0), i32(1 << 30)))
            mpl = jnp.minimum(mpl, jnp.where(has_src > 0, BIG, mpl0[t]))
            mpr = jnp.maximum(mpr, jnp.where(has_src > 0, -BIG, mpr0[t]))
            rem_t = remain[t]
            rem = rem_t - rem_end - 1
            beg = jnp.maximum(0, jnp.minimum(mpl, qlen - rem) - w)
            end = jnp.minimum(qlen, jnp.maximum(mpr, qlen - rem) + w)
            beg_sn = jnp.maximum(beg // pn, min_pb)
            end_sn = end // pn
            begsn[t] = beg_sn
            endsn[t] = end_sn
            cells = cells + jnp.where(active, (end_sn - beg_sn + 1) * pn, 0)
            cap = jnp.minimum(end_sn + 1, dp_sn - 1)
            ovfl = ovfl | (active & (cap - beg_sn + 2 > NSEG)).astype(i32)

            lo = beg_sn * pn
            c = lo + k                    # window order: lane k = column c
            lane = c & MASK
            lane1 = (c - 1) & MASK
            seg = c // pn
            band = seg <= end_sn
            qrow = qp[bases[t] * Wq + jnp.minimum(c, Wq - 1)]
            qrow = jnp.where((c >= 1) & (c <= qlen), qrow, 0)

            # --- M + E merges over predecessors (dp_xla._merge_preds) ---
            def merge(p, pv, acc):
                pred, pbeg, pend = pred_band(t, p, pv)
                _beg = jnp.maximum(beg_sn, pbeg)
                _end = jnp.minimum(jnp.minimum(pend + 1, end_sn), dp_sn - 1)
                preH = Hb[pred, lane]
                cand = jnp.where(c == 0, NEG, Hb[pred, lane1])
                boundary = jnp.where(pbeg < beg_sn, cand, inf)
                cand = jnp.where(c == _beg * pn, boundary, cand)
                if lin:
                    cand = jnp.maximum(cand + qrow, preH - e1)
                mmask = (seg >= _beg) & (seg <= _end) & pv
                if acc is None:
                    fill = (((seg >= beg_sn) & (seg < _beg))
                            | ((seg > _end) & (seg <= cap)))
                    h = jnp.where(mmask, cand, jnp.where(fill, inf, 0))
                else:
                    h = jnp.where(mmask, jnp.maximum(acc[0], cand), acc[0])
                if lin:
                    return h, h, h
                _ende = jnp.minimum(pend, end_sn)
                emask = (seg >= _beg) & (seg <= _ende) & pv
                preEs = [E1b[pred, lane]] + ([E2b[pred, lane]] if conv
                                             else [])
                if acc is None:
                    efill = (((seg >= beg_sn) & (seg < _beg))
                             | ((seg > _ende) & (seg <= end_sn)))
                    es = [jnp.where(emask, pe, jnp.where(efill, inf, 0))
                          for pe in preEs]
                else:
                    es = [jnp.where(emask, jnp.maximum(a, pe), a)
                          for a, pe in zip(acc[1:], preEs)]
                return h, es[0], (es[1] if conv else h)

            acc = merge(0, npre > 0, None)
            h, e1v, e2v = jax.lax.fori_loop(
                1, npre, lambda p, a: merge(p, True, a), acc)

            # --- F phase + fold (dp_xla row body) ---
            def seed_of(h0):
                return jnp.sum(jnp.where(k == 0, h0, 0))

            def f_scans(src, es, oes, seed):
                gvs = [jnp.where(band, jnp.maximum(src, inf) + k * e, NEG)
                       for e in es]
                Ms = kscan_max(gvs)
                Pms = shift(Ms, 1)
                out = []
                for Pm, e, oe in zip(Pms, es, oes):
                    F = jnp.where(k >= 1, Pm, NEG) - oe - (k - 1) * e
                    F = jnp.where(k == 0, seed - oe, F)
                    out.append(jnp.maximum(F, inf))
                return out

            e1row = e2row = f1row = f2row = zero
            if lin:
                gv = jnp.where(band, jnp.maximum(h, inf) + k * e1, NEG)
                (M,) = kscan_max([gv])
                hrow = jnp.where(band, jnp.maximum(M - k * e1, inf), h)
            elif not conv:
                h0 = h + jnp.where(band, qrow, 0)
                (f1,) = f_scans(jnp.where(band, h0, NEG), [e1], [oe1],
                                seed_of(h0))
                h1 = jnp.maximum(h0, e1v)
                hh = jnp.maximum(h1, f1)
                e1n = jnp.maximum(e1v - e1, hh - oe1)
                hrow = jnp.where(band, hh, h0)
                e1row = jnp.where(band, jnp.where(hh == h1, e1n, inf), e1v)
                f1row = jnp.where(band, f1, 0)
            else:
                h0 = h + jnp.where(band, qrow, 0)
                hpf = jnp.where(band, jnp.maximum(jnp.maximum(h0, e1v), e2v),
                                NEG)
                f1, f2 = f_scans(hpf, [e1, e2], [oe1, oe2], seed_of(h0))
                hh = jnp.maximum(jnp.maximum(hpf, f1), f2)
                hrow = jnp.where(band, hh, h0)
                e1row = jnp.where(band, jnp.maximum(e1v - e1, hh - oe1), e1v)
                e2row = jnp.where(band, jnp.maximum(e2v - e2, hh - oe2), e2v)
                f1row = jnp.where(band, f1, 0)
                f2row = jnp.where(band, f2, 0)
            Hb[t, lane] = hrow
            if not lin:
                E1b[t, lane] = e1row
            if conv:
                E2b[t, lane] = e2row

            # --- backtrack bits: [0:4] m_pick, [4:8] e1_pickM,
            # [8:12] e1_pickX, [12] e1_openM, [13] e1_openX, [14:18]
            # e2_pickM, [18:22] e2_pickX, [22] e2_openM, [23] e2_openX,
            # [24] f1_open, [25] f1_ext, [26] f1_gate, [27] f2_open,
            # [28] f2_ext, [29] f2_gate; pick 15 = no hit. Linear gap: the
            # single E condition sits in both e1 picks, [24] = F possible.
            def bits(p, pv, acc):
                pred, pbeg, pend = pred_band(t, p, pv)
                plo = pbeg * pn
                phi = (pend + 1) * pn - 1
                m_in = pv & (c - 1 >= plo) & (c - 1 <= phi)
                okp = pv & (c >= plo) & (c <= phi)
                preH = jnp.where(okp, Hb[pred, lane], NEG)
                mh = (jnp.where(m_in, Hb[pred, lane1], NEG) + qrow) == hrow
                no = k < 0
                if lin:
                    e1m = e1x = (preH - e1) == hrow
                    e1o = e2m = e2x = e2o = no
                else:
                    pe1 = jnp.where(okp, E1b[pred, lane], NEG)
                    e1m = hrow == pe1
                    e1x = e1row == (pe1 - e1)
                    e1o = (preH - oe1) == pe1
                    if conv:
                        pe2 = jnp.where(okp, E2b[pred, lane], NEG)
                        e2m = hrow == pe2
                        e2x = e2row == (pe2 - e2)
                        e2o = (preH - oe2) == pe2
                    else:
                        e2m = e2x = e2o = no
                if acc is None:
                    return tuple(
                        [jnp.where(mh, i32(0), i32(15)),
                         jnp.where(e1m, i32(0), i32(15)),
                         jnp.where(e1x, i32(0), i32(15)),
                         (e1m & e1o).astype(i32), (e1x & e1o).astype(i32),
                         jnp.where(e2m, i32(0), i32(15)),
                         jnp.where(e2x, i32(0), i32(15)),
                         (e2m & e2o).astype(i32), (e2x & e2o).astype(i32)])
                a = list(acc)
                for pi, oi, hit, op in ((0, None, mh, None),
                                        (1, 3, e1m, e1o), (2, 4, e1x, e1o),
                                        (5, 7, e2m, e2o), (6, 8, e2x, e2o)):
                    u = hit & (a[pi] == 15)
                    if oi is not None:
                        a[oi] = jnp.where(u, op.astype(i32), a[oi])
                    a[pi] = jnp.where(u, p, a[pi])
                return tuple(a)

            acc = bits(0, npre > 0, None)
            acc = jax.lax.fori_loop(1, npre, lambda p, a: bits(p, True, a),
                                    acc)
            hprev, f1prev, f2prev = [jnp.where(k == 0, 0, v) for v in
                                     shift([hrow, f1row, f2row], 1)]
            if lin:
                fb = jnp.where((hprev - e1) == hrow, i32(1 << 24), i32(0))
            else:
                fb = (jnp.where((hprev - oe1) == f1row, i32(1 << 24), i32(0))
                      | jnp.where((f1prev - e1) == f1row, i32(1 << 25),
                                  i32(0))
                      | jnp.where(hrow == f1row, i32(1 << 26), i32(0)))
                if conv:
                    fb = (fb
                          | jnp.where((hprev - oe2) == f2row, i32(1 << 27),
                                      i32(0))
                          | jnp.where((f2prev - e2) == f2row, i32(1 << 28),
                                      i32(0))
                          | jnp.where(hrow == f2row, i32(1 << 29), i32(0)))
            BTb[t, lane] = (acc[0] | (acc[1] << 4) | (acc[2] << 8)
                            | (acc[3] << 12) | (acc[4] << 13)
                            | (acc[5] << 14) | (acc[6] << 18)
                            | (acc[7] << 22) | (acc[8] << 23) | fb)

            # --- row max with the reference tie-breaks (dp_xla._row_max):
            # lexicographic argmax by (value desc, lane-in-segment asc,
            # segment priority asc), the end segment first ---
            lseg = seg - beg_sn
            v = jnp.where(band & (c <= qlen), hrow, inf)
            prio = jnp.where(lseg == end_sn - beg_sn, -1, lseg)
            key = (k & (pn - 1)) * (1 << 15) + (prio * 1024 + lseg + 1024)
            gmax = jnp.max(v)
            kpick = jnp.min(jnp.where(v == gmax, key, 1 << 30))
            wseg = ((kpick & ((1 << 15) - 1)) - 1024) & 1023
            mi = jnp.where(gmax > inf, (beg_sn + wseg) * pn + (kpick >> 15),
                           -1)
            stop_now = active & False
            if extend:
                better = gmax > bs
                if cfg.use_zdrop:
                    zlim = zdrop + e1 * jnp.abs(brem - rem_t - (mi - bj))
                    stop_now = active & ~better & (bs - gmax > zlim)
                take = active & better
                bs = jnp.where(take, gmax, bs)
                bi = jnp.where(take, t, bi)
                bj = jnp.where(take, mi, bj)
                brem = jnp.where(take, rem_t, brem)
                stopped = stopped | stop_now.astype(i32)
            rms[t] = jnp.where(active & ~stop_now, RM_OK | (mi + 1), 0)
            barrier()
            return bs, bi, bj, brem, stopped, cells, ovfl

        limit = jnp.minimum(n_rows - 1, R - 1)
        carry = (inf, i32(0), i32(0), remain[0], i32(0), i32(0), ovfl0)
        bs, bi, bj, _, _, cells, ovfl = jax.lax.fori_loop(1, limit, body,
                                                          carry)

        if cfg.align_mode == GLOBAL_MODE:
            # best over the sink's predecessors at column min(qlen, dp_end)
            # (ref :1284-1300): in-id order, strict greater
            sink = n_rows - 1

            def sink_best(p, best):
                bs, bi, bj = best
                pred = pre_idx[sink * P + p]
                ec = jnp.minimum(qlen, (endsn[pred] + 1) * pn - 1)
                lo_p = begsn[pred] * pn
                val = jnp.where((ec >= lo_p) & (ec < lo_p + WB),
                                Hb[pred, ec & MASK], 0)
                better = val > bs
                return (jnp.where(better, val, bs),
                        jnp.where(better, pred, bi),
                        jnp.where(better, ec, bj))
            bs, bi, bj = jax.lax.fori_loop(0, pre_n[sink], sink_best,
                                           (bs, bi, bj))
        misc_o[M_BEST] = bs
        misc_o[M_BI] = bi
        misc_o[M_BJ] = bj
        misc_o[M_CELLS] = cells
        misc_o[M_OVFL] = ovfl

        # ---------------- backtrack walk: one bits word per step ----------
        def walk(st):
            i, j, cur_op, if_, nst, fail, _ = st
            lo_i = begsn[i] * pn
            b = jnp.where((j >= lo_i) & (j < lo_i + WB), BTb[i, j & MASK],
                          INVALID_BITS)
            curM = (cur_op & BT_M) > 0
            mp = b & 15
            m_possible = mp < 15
            if lin:
                e_pick = (b >> 4) & 15
                e_possible = e_pick < 15
                e_op = i32(BT_ALL)
                f_possible = ((b >> 24) & 1) > 0
                f_op = i32(BT_ALL)
            else:
                pe1 = jnp.where(curM, (b >> 4) & 15, (b >> 8) & 15)
                e1open = jnp.where(curM, (b >> 12) & 1, (b >> 13) & 1)
                e1hit = ((cur_op & BT_E1) > 0) & (pe1 < 15)
                if conv:
                    pe2 = jnp.where(curM, (b >> 14) & 15, (b >> 18) & 15)
                    e2open = jnp.where(curM, (b >> 22) & 1, (b >> 23) & 1)
                    e2hit = ((cur_op & BT_E2) > 0) & (pe2 < 15)
                else:
                    pe2 = i32(15)
                    e2open = i32(0)
                    e2hit = e1hit & False
                # candidate order (p0.e1, p0.e2, p1.e1, ...): first wins
                k1 = jnp.where(e1hit, 2 * pe1, 99)
                k2 = jnp.where(e2hit, 2 * pe2 + 1, 99)
                use_e1 = k1 <= k2
                e_possible = jnp.minimum(k1, k2) < 99
                e_pick = jnp.where(use_e1, pe1, pe2)
                e_op = jnp.where(
                    use_e1,
                    jnp.where(e1open > 0, i32(BT_M | BT_F), i32(BT_E1)),
                    jnp.where(e2open > 0, i32(BT_M | BT_F), i32(BT_E2)))
                f1o = ((b >> 24) & 1) > 0
                f1x = ((b >> 25) & 1) > 0
                f1g = ((b >> 26) & 1) > 0
                hit_f1 = (((cur_op & BT_F1) > 0) & (f1g | ~curM)
                          & (f1o | f1x))
                op_f1 = jnp.where(f1o, i32(BT_M | BT_E), i32(BT_F1))
                if conv:
                    f2o = ((b >> 27) & 1) > 0
                    f2x = ((b >> 28) & 1) > 0
                    f2g = ((b >> 29) & 1) > 0
                    hit_f2 = (((cur_op & BT_F2) > 0) & (f2g | ~curM)
                              & (f2o | f2x))
                    op_f2 = jnp.where(f2o, i32(BT_M | BT_E), i32(BT_F2))
                else:
                    hit_f2 = hit_f1 & False
                    op_f2 = i32(BT_ALL)
                f_possible = hit_f1 | hit_f2
                f_op = jnp.where(hit_f1, op_f1, op_f2)
            first = if_ > 0
            use_m1 = curM & ~first & m_possible
            use_e = ~use_m1 & e_possible
            if not lin:
                use_e = use_e & ((cur_op & BT_E) > 0)
            use_f = ~use_m1 & ~use_e & f_possible
            if not lin:
                use_f = use_f & ((cur_op & BT_F) > 0)
            use_m2 = ~use_m1 & ~use_e & ~use_f & first & m_possible
            if not lin:
                use_m2 = use_m2 & curM
            any_hit = use_m1 | use_e | use_f | use_m2
            use_m = use_m1 | use_m2
            m_pred = pre_idx[i * P + jnp.minimum(mp, P - 1)]
            e_pred = pre_idx[i * P + jnp.minimum(e_pick, P - 1)]
            op = jnp.where(use_m, i32(0), jnp.where(use_e, i32(2), i32(1)))
            steps_o[nst] = op | (i << 2) | (j << 14)
            nst = nst + any_hit.astype(i32)
            fail = fail | (~any_hit).astype(i32)
            new_i = jnp.where(use_m, m_pred, jnp.where(use_e, e_pred, i))
            new_j = jnp.where(use_m | use_f, j - 1, j)
            new_cur = jnp.where(use_m, i32(BT_ALL),
                                jnp.where(use_e, e_op,
                                          jnp.where(use_f, f_op, cur_op)))
            done = ((fail > 0) | (new_i <= 0) | (new_j <= 0)
                    | (nst >= cfg.lmax))
            return (new_i, new_j, new_cur, jnp.where(use_m, 0, if_), nst,
                    fail, done.astype(i32))

        done0 = ((bi <= 0) | (bj <= 0) | (ovfl > 0)).astype(i32)
        i, j, _, _, nst, fail, _ = jax.lax.while_loop(
            lambda st: st[6] == 0, walk,
            (bi, bj, i32(BT_ALL), i32(1), i32(0), i32(0), done0))
        misc_o[M_NSTEPS] = nst
        misc_o[M_FAIL] = fail
        misc_o[M_ENDI] = i
        misc_o[M_ENDJ] = j

    return kernel


def band_dp_batch(cfg: BandConfig, scal, bases, pre_idx, pre_n, remain,
                  mpl0, mpr0, qcodes, *, interpret: bool = False):
    """Batched banded DP + walk. Every argument has a leading batch axis:
    scal [B, S_NSCAL + m*m] (the score matrix at its tail), bases/pre_n/
    remain/mpl0/mpr0 [B, R], pre_idx [B, R, P], qcodes [B, Wq] (column c
    holds query[c-1]). Returns (misc [B, M_NMISC], steps [B, lmax]).

    The kernel runs only on a GPU, or under ``interpret=True`` (tests)."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the banded DP kernel runs on a GPU; pass interpret=True to "
            f"emulate it on {jax.default_backend()!r}")
    return _band_dp(cfg, interpret, scal, bases, pre_idx, pre_n, remain,
                    mpl0, mpr0, qcodes)


@partial(jax.jit, static_argnums=(0, 1))
def _band_dp(cfg: BandConfig, interpret: bool, scal, bases, pre_idx, pre_n,
             remain, mpl0, mpr0, qcodes):
    B = bases.shape[0]
    R, WB, P, m, Wq = cfg.R, cfg.WB, cfg.P, cfg.m, cfg.Wq
    assert WB & (WB - 1) == 0 and R <= MAX_ROWS
    assert qcodes.shape[1] == Wq and pre_idx.shape[1:] == (R, P)
    i32 = jnp.int32
    mat = scal[:, S_NSCAL:].astype(i32).reshape(B, m, m)
    # query profile qp[b, base, c] = mat[base, query[c - 1]]
    qp = jax.vmap(lambda M, q: M[:, q])(mat, qcodes.astype(i32))
    NS = 16
    scal16 = jnp.zeros((B, NS), i32).at[:, :S_NSCAL].set(
        scal[:, :S_NSCAL].astype(i32))

    def per(*shape):
        return pl.BlockSpec((None, *shape), lambda b: (b, *([0] * len(shape))))

    RE1, RE2 = _e_rows(cfg)
    out_shape = [
        jax.ShapeDtypeStruct((B, M_NMISC), i32),
        jax.ShapeDtypeStruct((B, cfg.lmax), i32),
        jax.ShapeDtypeStruct((B, R, WB), i32),      # H
        jax.ShapeDtypeStruct((B, RE1, WB), i32),    # E1
        jax.ShapeDtypeStruct((B, RE2, WB), i32),    # E2
        jax.ShapeDtypeStruct((B, R, WB), i32),      # backtrack bits
        jax.ShapeDtypeStruct((B, R), i32),          # beg_sn per row
        jax.ShapeDtypeStruct((B, R), i32),          # end_sn per row
        jax.ShapeDtypeStruct((B, R), i32),          # rms per row
        jax.ShapeDtypeStruct((B, 2, 3, WB), i32),   # shift scratch
    ]
    out_specs = [per(M_NMISC), per(cfg.lmax), per(R, WB), per(RE1, WB),
                 per(RE2, WB), per(R, WB), per(R), per(R), per(R),
                 per(2, 3, WB)]
    in_specs = [per(NS), per(R), per(R * P), per(R), per(R), per(R),
                per(R), per(m * Wq)]
    outs = pl.pallas_call(
        _make_kernel(cfg, interpret),
        grid=(B,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="abpoa_band_dp",
    )(scal16, bases.astype(i32), pre_idx.astype(i32).reshape(B, R * P),
      pre_n.astype(i32), remain.astype(i32), mpl0.astype(i32),
      mpr0.astype(i32), qp.reshape(B, m * Wq))
    return outs[0], outs[1]
