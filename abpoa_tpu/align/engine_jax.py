"""JAX device engine: host wrapper around the device DP ends.

Exports the POAGraph to padded dense arrays (SURVEY design delta #1:
pointer-chased adjacency -> fixed-capacity int32 arrays + validity masks),
stacks a group of exports into one device round, and picks the DP end from
the platform and the input: the banded GPU kernel (ops/dp_band.py) or the
plain XLA reference (ops/dp_xla.py + ops/bt_xla.py). Both return the same
(misc, packed step stream) pair, which the host replays into a cigar
(ops/bt_xla.replay_steps) or fuses directly (NativeGraph.fuse_steps).
Local mode and subgraph windows fetch the XLA planes and backtrack on the
host, reusing the oracle's backtrack verbatim so the M->D->I / indel_first
tie-breaking (ref src/simd_abpoa_align.c:107-123) is shared code with the
bit-exact engine. Subgraph exports (beg_index/end_index slice the
topological interval) become batch instances in parallel/batch.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..params import (LOCAL_MODE, LINEAR_GAP, AFFINE_GAP, CONVEX_GAP,
                      SRC_NODE_ID, SINK_NODE_ID)
from .engine_np import (AlignResult, _Ctx, _simd_params,
                        INT16_MAX, INT16_MIN, INT32_MIN)


def _bucket(x: int, lo: int) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def score_dispatch(params, gn: int, qlen: int):
    """pn + inf_min from the oracle's 16/32-bit dispatch (shared single
    source of truth; the device engines compute int32 but inherit the lane
    geometry so band snapping matches the oracle bit-exactly)."""
    from .engine_np import score_width_dispatch
    _bits, pn, _log_n, inf_min = score_width_dispatch(params, gn, qlen)
    return pn, inf_min


@dataclasses.dataclass
class DenseGraph:
    """Host-side dense export of one POAGraph for the device DP."""
    n_rows: int
    qlen: int
    pn: int
    inf_min: int
    bases: np.ndarray
    pre_idx: np.ndarray
    pre_n: np.ndarray
    out_idx: np.ndarray
    out_n: np.ndarray
    remain: np.ndarray
    mpl: np.ndarray
    mpr: np.ndarray
    qcol: np.ndarray
    pre_index: list | None   # ragged, for host backtrack (lazy)
    R: int
    W: int
    P: int
    O: int
    beg_index: int = 0       # subgraph: dp row 0 = this topo index
    rowmask: np.ndarray | None = None  # subgraph reachability (None = all)


def subgraph_index_map(graph, beg_index: int, end_index: int) -> np.ndarray:
    """Reachability mask within the subgraph interval
    (ref simd_abpoa_align_sequence_to_subgraph :1650-1660). CSR-based;
    the row-by-row sweep runs in C when the native lib is available
    (~1.3 ms/window in numpy was the seeded path's hottest host item)."""
    from .. import native
    c = graph.build_csr()
    out_flat = c["out_flat"]
    out_off = c["out_off"]
    if native.get_lib() is not None:
        mask = native.subgraph_reach(
            graph.node_n, beg_index, end_index,
            np.ascontiguousarray(out_flat, dtype=np.int32),
            np.ascontiguousarray(out_off, dtype=np.int32),
            np.ascontiguousarray(graph.index_to_node_id[:graph.node_n],
                                 dtype=np.int32),
            np.ascontiguousarray(graph.node_id_to_index[:graph.node_n],
                                 dtype=np.int32))
        return mask.astype(bool)
    n2i = np.asarray(graph.node_id_to_index, dtype=np.int64)
    index_map = np.zeros(graph.node_n, dtype=bool)
    index_map[beg_index] = index_map[end_index] = True
    i2n = graph.index_to_node_id
    for i in range(beg_index, end_index - 1):
        if not index_map[i]:
            continue
        nid = int(i2n[i])
        index_map[n2i[out_flat[out_off[nid]:out_off[nid + 1]]]] = True
    return index_map


def export_dense(graph, params, query, min_R=64, min_W=256,
                 force_R=None, force_W=None, force_P=None,
                 force_O=None, beg_index=0, end_index=None,
                 index_map=None) -> DenseGraph:
    """Flatten the DAG (in topo index order) into padded arrays.

    force_* pin the padded capacities so a batch of instances shares one
    static kernel shape (parallel/batch.py re-pads a round's group to its
    common maximum). beg_index/end_index/index_map restrict the export to a
    subgraph interval (anchored/windowed POA): dp row t = topo index
    beg_index+t; adjacency is filtered by the reachability map exactly like
    the oracle's pre_index (engine_np :177-184).
    """
    full = end_index is None
    if full:
        end_index = graph.node_n - 1
    n = end_index - beg_index + 1
    qlen = len(query)
    pn, inf_min = score_dispatch(params, n, qlen)
    i2n = graph.index_to_node_id
    n2i = graph.node_id_to_index
    # rows bucket: power-of-two up to 512, then 64-steps — the XLA end
    # sweeps every padded row, so a pure pow2 ladder would nearly double
    # the work of an 800-row graph
    R = force_R if force_R else (
        _bucket(n, min_R) if n <= 512 else (int(n) + 63) // 64 * 64)
    W_needed = ((qlen + pn) // pn) * pn
    W = force_W if force_W else _bucket(W_needed, min_W)
    banded = params.wb >= 0

    ids = np.asarray(i2n[beg_index:end_index + 1], dtype=np.int64)
    bases = np.zeros(R, dtype=np.int32)
    csr = getattr(graph, "_csr", None)
    if not full:
        # subgraph export: filtered adjacency, vectorized over the CSR
        # snapshot (walking Node objects materialized the native store
        # per window, dominating the seeded pipeline's host time)
        if index_map is None:
            index_map = subgraph_index_map(graph, beg_index, end_index)
        c = graph.build_csr()
        rowmask = np.zeros(R, dtype=np.int32)
        rowmask[:n] = index_map[beg_index:end_index + 1]
        n2i_np = np.asarray(n2i, dtype=np.int64)
        bases[:n] = c["bases"][ids]
        row_live = index_map[beg_index:end_index + 1]

        def _filtered(flat, off, cnt, also_map: bool):
            raw_cnt = cnt[ids].astype(np.int64)
            s = np.repeat(off[:-1][ids].astype(np.int64), raw_cnt)
            w = np.arange(len(s)) - np.repeat(
                np.cumsum(raw_cnt) - raw_cnt, raw_cnt)
            tgt = n2i_np[flat[s + w]]
            rows = np.repeat(np.arange(n), raw_cnt)
            keep = (row_live[rows] & (tgt >= beg_index)
                    & (tgt <= end_index))
            if also_map:
                keep &= index_map[tgt]
            rows_k = rows[keep]
            vals = (tgt[keep] - beg_index).astype(np.int32)
            counts = np.bincount(rows_k, minlength=n).astype(np.int32)
            starts = np.concatenate(
                ([0], np.cumsum(counts)[:-1])).astype(np.int64)
            pos = np.arange(len(rows_k)) - starts[rows_k]
            return rows_k, pos, vals, counts

        rin, pin, vin, pre_cnt = _filtered(c["in_flat"], c["in_off"],
                                           c["in_cnt"], True)
        rout, pout, vout, out_cnt = _filtered(c["out_flat"], c["out_off"],
                                              c["out_cnt"], False)
        P = force_P if force_P else _bucket(
            max(int(pre_cnt.max(initial=1)), 1), 2)
        O = force_O if force_O else _bucket(
            max(int(out_cnt.max(initial=1)), 1), 2)
        pre_idx = np.zeros((R, P), dtype=np.int32)
        pre_n = np.zeros(R, dtype=np.int32)
        out_idx = np.zeros((R, O), dtype=np.int32)
        out_n = np.zeros(R, dtype=np.int32)
        pre_n[:n] = pre_cnt
        out_n[:n] = out_cnt
        pre_idx[rin, pin] = vin
        out_idx[rout, pout] = vout
        remain = np.zeros(R, dtype=np.int32)
        mpl = np.zeros(R, dtype=np.int32)
        mpr = np.zeros(R, dtype=np.int32)
        if graph.node_id_to_max_remain is not None:
            remain[:n] = graph.node_id_to_max_remain[ids]
        if banded:
            mpl[:n] = graph.node_id_to_max_pos_left[ids]
            mpr[:n] = graph.node_id_to_max_pos_right[ids]
        qcol = np.zeros(W, dtype=np.int32)
        qcol[1:qlen + 1] = np.asarray(query, dtype=np.int32)
        dg = DenseGraph(n, qlen, pn, inf_min, bases, pre_idx, pre_n,
                        out_idx, out_n, remain, mpl, mpr, qcol,
                        None, R, W, P, O)
        dg.beg_index = beg_index
        dg.rowmask = rowmask
        return dg
    if (csr is not None and graph.is_topological_sorted
            and csr["n"] == n):
        # reuse the flat adjacency snapshot built by topological_sort
        bases[:n] = csr["bases"][ids]
        pre_cnt = csr["in_cnt"][ids]
        out_cnt = csr["out_cnt"][ids]
        s_in = np.repeat(csr["in_off"][:-1][ids], pre_cnt)
        s_out = np.repeat(csr["out_off"][:-1][ids], out_cnt)
        w_in = np.arange(len(s_in)) - np.repeat(
            np.cumsum(pre_cnt) - pre_cnt, pre_cnt)
        w_out = np.arange(len(s_out)) - np.repeat(
            np.cumsum(out_cnt) - out_cnt, out_cnt)
        flat_in = csr["in_flat"][s_in + w_in].astype(np.int64)
        flat_out = csr["out_flat"][s_out + w_out].astype(np.int64)
    else:
        node = graph.node
        in_lists = [node[int(nid)].in_id for nid in ids]
        out_lists_ = [node[int(nid)].out_id for nid in ids]
        pre_cnt = np.fromiter(map(len, in_lists), dtype=np.int32, count=n)
        out_cnt = np.fromiter(map(len, out_lists_), dtype=np.int32, count=n)
        bases[:n] = np.fromiter((node[int(nid)].base for nid in ids),
                                dtype=np.int32, count=n)
        flat_in = np.fromiter((x for lst in in_lists for x in lst),
                              dtype=np.int64, count=int(pre_cnt.sum()))
        flat_out = np.fromiter((x for lst in out_lists_ for x in lst),
                               dtype=np.int64, count=int(out_cnt.sum()))
    P = force_P if force_P else _bucket(max(int(pre_cnt.max(initial=1)), 1),
                                        2)
    O = force_O if force_O else _bucket(max(int(out_cnt.max(initial=1)), 1),
                                        2)
    n2i_np = np.asarray(n2i, dtype=np.int64)
    pre_idx = np.zeros((R, P), dtype=np.int32)
    pre_n = np.zeros(R, dtype=np.int32)
    out_idx = np.zeros((R, O), dtype=np.int32)
    out_n = np.zeros(R, dtype=np.int32)
    pre_n[:n] = pre_cnt
    out_n[:n] = out_cnt
    rows_in = np.repeat(np.arange(n), pre_cnt)
    offs_in = np.cumsum(pre_cnt) - pre_cnt
    cols_in = np.arange(len(flat_in)) - np.repeat(offs_in, pre_cnt)
    pre_idx[rows_in, cols_in] = n2i_np[flat_in]
    rows_out = np.repeat(np.arange(n), out_cnt)
    offs_out = np.cumsum(out_cnt) - out_cnt
    cols_out = np.arange(len(flat_out)) - np.repeat(offs_out, out_cnt)
    out_idx[rows_out, cols_out] = n2i_np[flat_out]
    pre_lists = None  # built lazily for the host backtrack only

    remain = np.zeros(R, dtype=np.int32)
    mpl = np.zeros(R, dtype=np.int32)
    mpr = np.zeros(R, dtype=np.int32)
    if graph.node_id_to_max_remain is not None:
        remain[:n] = graph.node_id_to_max_remain[np.asarray(i2n[:n],
                                                            dtype=np.int64)]
    if banded:
        mpl[:n] = graph.node_id_to_max_pos_left[np.asarray(i2n[:n],
                                                           dtype=np.int64)]
        mpr[:n] = graph.node_id_to_max_pos_right[np.asarray(i2n[:n],
                                                            dtype=np.int64)]
    qcol = np.zeros(W, dtype=np.int32)
    qcol[1:qlen + 1] = np.asarray(query, dtype=np.int32)
    return DenseGraph(n, qlen, pn, inf_min, bases, pre_idx, pre_n,
                      out_idx, out_n, remain, mpl, mpr, qcol,
                      pre_lists, R, W, P, O)


def repad_dense(dg: DenseGraph, R: int, W: int, P: int, O: int) -> DenseGraph:
    """Re-pad an exported DenseGraph to a batch group's common capacities
    without re-walking the graph."""
    if (R, W, P, O) == (dg.R, dg.W, dg.P, dg.O):
        return dg
    n = dg.n_rows

    def padv(a, size):
        out = np.zeros(size, dtype=a.dtype)
        out[:len(a)] = a
        return out

    def padm(a, rows, cols):
        out = np.zeros((rows, cols), dtype=a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    return DenseGraph(n, dg.qlen, dg.pn, dg.inf_min,
                      padv(dg.bases, R), padm(dg.pre_idx, R, P),
                      padv(dg.pre_n, R), padm(dg.out_idx, R, O),
                      padv(dg.out_n, R), padv(dg.remain, R),
                      padv(dg.mpl, R), padv(dg.mpr, R),
                      padv(dg.qcol, W), dg.pre_index, R, W, P, O,
                      dg.beg_index,
                      padv(dg.rowmask, R) if dg.rowmask is not None
                      else None)


def _make_inputs(dg: DenseGraph, params):
    """One instance's (DPConfig, DPInputs) for dp_xla.banded_poa_dp."""
    import jax.numpy as jnp
    cfg, inp = xla_inputs([dg], params)
    return cfg, type(inp)(*(jnp.asarray(x[0]) for x in inp))


def _backtrack_from_planes(graph, params, query, dg: DenseGraph,
                           H, E1, E2, F1, F2, dp_beg, dp_end,
                           best_score, best_i, best_j) -> AlignResult:
    """Host backtrack reusing the oracle's methods over device planes."""
    from .. import cigar  # noqa: F401  (oracle methods import it as cg)
    res = AlignResult()
    res.best_score = int(best_score)
    ctx = object.__new__(_Ctx)
    ctx.g = graph
    ctx.p = params
    ctx.res = res
    ctx.query = np.asarray(query, dtype=np.int64)
    ctx.qlen = dg.qlen
    # subgraph windows: dp row t = topo index dg.beg_index + t (the
    # oracle's mapping, engine_np.py:654-716); whole-graph exports have 0
    ctx.beg_index = dg.beg_index
    ctx.mat = params.mat
    ctx.it = np.int32
    ctx.inf_min = np.int32(dg.inf_min)
    ctx.e1 = np.int32(params.gap_ext1)
    ctx.e2 = np.int32(params.gap_ext2)
    ctx.o1 = np.int32(params.gap_open1)
    ctx.o2 = np.int32(params.gap_open2)
    ctx.oe1 = np.int32(params.gap_oe1)
    ctx.oe2 = np.int32(params.gap_oe2)
    if dg.pre_index is None:
        dg.pre_index = [dg.pre_idx[t, :dg.pre_n[t]].tolist()
                        for t in range(dg.n_rows)]
    ctx.pre_index = dg.pre_index
    # flat bases-by-dp-row: the walk never touches graph.node (on the
    # native store that property re-materializes the full Node snapshot
    # once per fusion round — O(nodes) Python objects per window)
    ctx.bases_row = dg.bases
    ctx.dp_beg = dp_beg
    ctx.dp_end = dp_end
    ctx.H, ctx.E1, ctx.E2, ctx.F1, ctx.F2 = H, E1, E2, F1, F2
    ctx.best_score = int(best_score)
    ctx.best_i = int(best_i)
    ctx.best_j = int(best_j)
    local = params.align_mode == LOCAL_MODE
    if params.ret_cigar:
        if params.gap_mode == LINEAR_GAP:
            ctx._backtrack_lg(local)
        elif params.gap_mode == AFFINE_GAP:
            ctx._backtrack_ag(local)
        else:
            ctx._backtrack_cg(local)
    return res


def _round_up(x: int, m: int) -> int:
    return (int(x) + m - 1) // m * m


def pick_engine(engine=None, interpret: bool = False) -> str:
    """The device DP end for this platform: "kernel" (ops/dp_band.py) on a
    GPU, "xla" (ops/dp_xla.py + ops/bt_xla.py, the plain reference)
    elsewhere. engine="xla" forces the reference; engine="kernel" off a GPU
    is an error unless interpret=True (tests emulate the kernel)."""
    import jax
    if engine == "xla":
        return "xla"
    if engine not in (None, "auto", "kernel"):
        raise ValueError(f"unknown device engine {engine!r}")
    gpu = jax.default_backend() == "gpu"
    if engine == "kernel" and not (gpu or interpret):
        raise RuntimeError(
            f"the banded DP kernel needs a GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to emulate it")
    return "kernel" if (gpu or engine == "kernel") else "xla"


def _scal(dg: DenseGraph, params) -> np.ndarray:
    """Per-instance scalar vector (ops/layout.py S_*) + score matrix."""
    from ..ops import layout as L
    qlen = dg.qlen
    w = qlen if params.wb < 0 else params.wb + int(params.wf * qlen)
    s = np.zeros(L.S_NSCAL, dtype=np.int64)
    s[L.S_QLEN] = qlen
    s[L.S_NROWS] = dg.n_rows
    s[L.S_W] = w
    s[L.S_INF] = dg.inf_min
    s[L.S_REMEND] = dg.remain[dg.n_rows - 1]
    s[L.S_E1], s[L.S_O1], s[L.S_OE1] = (params.gap_ext1, params.gap_open1,
                                        params.gap_oe1)
    s[L.S_E2], s[L.S_O2], s[L.S_OE2] = (params.gap_ext2, params.gap_open2,
                                        params.gap_oe2)
    s[L.S_ZDROP] = params.zdrop
    s[L.S_DPSN] = qlen // dg.pn + 1
    return np.concatenate([s, np.asarray(params.mat,
                                         dtype=np.int64).reshape(-1)])


def kernel_inputs(dgs, params):
    """Stack a group of exports (common R/W/P padding) for ops/dp_band:
    (BandConfig, host arrays). R pads to a multiple of 256 and the query
    profile to a power of two, so the compiled kernels stay few as graphs
    grow; the row loop only runs to each instance's own n_rows."""
    from ..ops.dp_band import BandConfig, pick_wb
    pn = dgs[0].pn
    qmax = max(dg.qlen for dg in dgs)
    R = _round_up(dgs[0].R, 256)
    Wq = _bucket(qmax + 1, 256)
    WB = max(pick_wb(params, dg.qlen, pn) for dg in dgs)
    P = dgs[0].P
    lmax = _round_up(R + Wq, 64)
    cfg = BandConfig(gap_mode=params.gap_mode, align_mode=params.align_mode,
                     pn=pn, R=R, WB=WB, Wq=Wq, P=P, m=params.m,
                     use_zdrop=params.zdrop > 0, lmax=lmax)
    B = len(dgs)
    scal = np.stack([_scal(dg, params) for dg in dgs]).astype(np.int32)
    rows = np.zeros((5, B, R), dtype=np.int32)
    pre_idx = np.zeros((B, R, P), dtype=np.int32)
    qcodes = np.zeros((B, Wq), dtype=np.int32)
    for b, dg in enumerate(dgs):
        r = dg.R
        rows[0, b, :r] = dg.bases
        rows[1, b, :r] = dg.pre_n
        rows[2, b, :r] = dg.remain
        rows[3, b, :r] = dg.mpl
        rows[4, b, :r] = dg.mpr
        pre_idx[b, :r] = dg.pre_idx
        qcodes[b, :dg.qlen + 1] = dg.qcol[:dg.qlen + 1]
    return cfg, (scal, rows[0], pre_idx, rows[1], rows[2], rows[3], rows[4],
                 qcodes)


def xla_inputs(dgs, params):
    """Stack a group of exports (common padding) into one batched
    dp_xla.DPInputs of host arrays: (DPConfig, DPInputs)."""
    from ..ops.dp_xla import DPConfig, DPInputs
    dg0 = dgs[0]
    cfg = DPConfig(gap_mode=params.gap_mode, align_mode=params.align_mode,
                   pn=dg0.pn, R=dg0.R, W=dg0.W, P=dg0.P, O=dg0.O,
                   banded=params.wb >= 0, use_zdrop=params.zdrop > 0)
    i32 = np.int32
    w = [dg.qlen if params.wb < 0 else params.wb + int(params.wf * dg.qlen)
         for dg in dgs]

    def col(f):
        return np.stack([getattr(dg, f) for dg in dgs]).astype(i32)

    def sc(v):
        return np.full(len(dgs), v, dtype=i32)
    inp = DPInputs(
        bases=col("bases"), pre_idx=col("pre_idx"), pre_n=col("pre_n"),
        out_idx=col("out_idx"), out_n=col("out_n"), remain=col("remain"),
        mpl=col("mpl"), mpr=col("mpr"), qcol=col("qcol"),
        mat=np.broadcast_to(np.asarray(params.mat, dtype=i32),
                            (len(dgs), params.m, params.m)),
        qlen=np.array([dg.qlen for dg in dgs], i32),
        n_rows=np.array([dg.n_rows for dg in dgs], i32),
        w=np.array(w, i32),
        inf_min=np.array([dg.inf_min for dg in dgs], i32),
        remain_end=np.array([dg.remain[dg.n_rows - 1] for dg in dgs], i32),
        e1=sc(params.gap_ext1), o1=sc(params.gap_open1),
        oe1=sc(params.gap_oe1), e2=sc(params.gap_ext2),
        o2=sc(params.gap_open2), oe2=sc(params.gap_oe2),
        zdrop=sc(params.zdrop), max_mat=sc(params.max_mat))
    return cfg, inp


def round_kind(engine: str, dgs, params) -> str:
    """Which device path a round group takes: "kernel" (ops/dp_band.py),
    "xla" (dp_xla + bt_xla walk, misc + steps leave the device) or
    "planes" (dp_xla planes to the host backtrack; local mode, whose walk
    stops on zero cells). Chosen from the input."""
    from ..ops import dp_band
    from ..ops.layout import MAX_ROWS, MAX_COLS
    R = max(dg.R for dg in dgs)
    qmax = max(dg.qlen for dg in dgs)
    if engine == "kernel" and dp_band.covers(params, R, qmax):
        return "kernel"
    if (params.align_mode != LOCAL_MODE and R <= MAX_ROWS
            and qmax + 1 < MAX_COLS):
        return "xla"
    return "planes"


# device bytes one call may hold on each device; up to BatchPOA.N_SHARDS
# pipelined rounds are in flight at once
_CALL_BYTES = 8 << 30


def call_batch(n: int, inst_bytes: int, ndev: int = 1) -> int:
    """Instances per device call for a group of n: ndev x a power of two
    (live groups shrink as instances run out of reads, and a distinct batch
    would compile anew), capped so each device holds at most _CALL_BYTES
    at inst_bytes per instance."""
    cap = max(1, _CALL_BYTES // inst_bytes)
    cap = 1 << (cap.bit_length() - 1)
    per = -(-n // ndev)
    return ndev * min(cap, 1 << (per - 1).bit_length())


def device_round(kind: str, dgs, params, mesh=None, batch_axis="data",
                 interpret=False):
    """One device round for a group of exports with common padding (kind
    from round_kind). "kernel" and "xla" return device arrays (misc
    [n, M_NMISC], steps [n, L]); "planes" returns dp_xla.DPOutputs. The
    n = len(dgs) instances run in calls of call_batch instances, padded
    with a live instance, each sharded over the mesh's batch axis:
    instances are independent, so no collective runs."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    n = len(dgs)
    ndev = mesh.size if mesh is not None else 1
    if kind == "kernel":
        from ..ops.dp_band import band_dp_batch, instance_bytes
        cfg, arrs = kernel_inputs(dgs, params)
        fn = partial(band_dp_batch, cfg, interpret=interpret)
        key = ("kernel", cfg, interpret)
        inst_bytes = instance_bytes(cfg)
    else:
        cfg, inp = xla_inputs(dgs, params)
        arrs = (inp,)
        if kind == "xla":
            from ..ops.bt_xla import dp_bt_batch
            lmax = _round_up(cfg.R + cfg.W, 64)
            fn = partial(dp_bt_batch, cfg, lmax)
            key = ("xla", cfg, lmax)
        else:
            from ..ops.dp_xla import banded_poa_dp_batch
            fn = partial(banded_poa_dp_batch, cfg)
            key = ("planes", cfg)
        # dp_xla's five full-width planes plus the walk's stacked copy
        inst_bytes = 40 * cfg.R * cfg.W
    fn = _mesh_wrap(fn, key, mesh, batch_axis, len(arrs))
    BP = call_batch(n, inst_bytes, ndev)
    outs = []
    for s in range(0, n, BP):
        idx = np.arange(s, s + BP)
        idx = np.where(idx < n, idx, s)      # pad with a live instance
        chunk = jax.tree.map(lambda x: jnp.asarray(x[idx]), arrs)
        outs.append(fn(*chunk))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs)[:n], *outs)


_MESH_FN_CACHE: dict = {}


def _mesh_wrap(fn, key, mesh, batch_axis, n_in):
    """Data-parallel dispatch: shard every input's batch axis over the mesh
    and run fn per shard. Cached per static config, since a fresh jit
    object per round would retrace every round."""
    if mesh is None:
        return fn
    import jax
    from jax.sharding import PartitionSpec as P
    k = (key, tuple(d.id for d in mesh.devices.flat),
         tuple(mesh.axis_names), batch_axis, n_in)
    if k not in _MESH_FN_CACHE:
        _MESH_FN_CACHE[k] = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(P(batch_axis),) * n_in,
            out_specs=P(batch_axis), check_vma=False))
    return _MESH_FN_CACHE[k]


def replay_result(graph, params, query, misc, steps, row0=0) -> AlignResult:
    """AlignResult (cigar + counters) from one instance's misc row and step
    stream (ops/bt_xla.replay_steps)."""
    from ..ops import bt_xla
    from ..ops import layout as L
    res = AlignResult()
    res.best_score = int(misc[L.M_BEST])
    return bt_xla.replay_steps(graph, params, np.asarray(query), steps,
                               int(misc[L.M_NSTEPS]), int(misc[L.M_BI]),
                               int(misc[L.M_BJ]), int(misc[L.M_ENDI]),
                               int(misc[L.M_ENDJ]), res, row0=row0)


def planes_result(graph, params, query, dg: DenseGraph, out,
                  b: int = 0) -> AlignResult:
    """Instance b of a fetched planes round (dp_xla.DPOutputs of host
    arrays): the adaptive band state goes back to the graph, on reachable
    rows only (the oracle never touches a subgraph's dead rows), and the
    oracle's backtrack runs over the planes."""
    n, bi = dg.n_rows, dg.beg_index
    if params.wb >= 0:
        live = (np.ones(n, dtype=bool) if dg.rowmask is None
                else dg.rowmask[:n].astype(bool))
        ids = np.asarray(graph.index_to_node_id[bi:bi + n],
                         dtype=np.int64)[live]
        graph.node_id_to_max_pos_left[ids] = out.mpl[b, :n][live]
        graph.node_id_to_max_pos_right[ids] = out.mpr[b, :n][live]
    return _backtrack_from_planes(
        graph, params, query, dg, out.H[b, :n], out.E1[b, :n],
        out.E2[b, :n], out.F1[b, :n], out.F2[b, :n],
        out.dp_beg[b, :n].astype(np.int64),
        out.dp_end[b, :n].astype(np.int64), int(out.best_score[b]),
        int(out.best_i[b]), int(out.best_j[b]))


def align_device(graph, params, query, beg_node_id=SRC_NODE_ID,
                 end_node_id=SINK_NODE_ID, engine=None,
                 interpret=False) -> AlignResult:
    """Single-instance alignment through a device round (B = 1). A
    whole-graph alignment takes the end round_kind picks: only misc and the
    step stream come back, and band overflow or a walk dead end re-runs the
    instance on the host oracle. A subgraph window takes an XLA planes
    round; an empty one runs on the oracle, as in BatchPOA.run_seeded."""
    import jax
    from ..ops import layout as L
    from .engine_np import align_sequence_to_subgraph as oracle
    if (beg_node_id, end_node_id) != (SRC_NODE_ID, SINK_NODE_ID):
        if len(query) == 0:
            return oracle(graph, params, beg_node_id, end_node_id, query)
        return align_sequence_to_graph_jax(
            graph, params, query, int(graph.node_id_to_index[beg_node_id]),
            int(graph.node_id_to_index[end_node_id]))
    dg = export_dense(graph, params, query)
    kind = round_kind(pick_engine(engine, interpret), [dg], params)
    if kind == "planes":
        return align_sequence_to_graph_jax(graph, params, query)
    misc, steps = jax.device_get(device_round(kind, [dg], params,
                                              interpret=interpret))
    if misc[0, L.M_OVFL] or misc[0, L.M_FAIL]:
        return oracle(graph, params, SRC_NODE_ID, SINK_NODE_ID, query)
    return replay_result(graph, params, query, misc[0], steps[0])


def align_sequence_to_graph_jax(graph, params, query, beg_index=0,
                                end_index=None) -> AlignResult:
    """Single-instance alignment through an XLA planes round (B = 1): the
    whole graph, or the subgraph window of topological indices
    [beg_index, end_index]."""
    import jax
    dg = export_dense(graph, params, query, beg_index=beg_index,
                      end_index=end_index)
    out = jax.device_get(device_round("planes", [dg], params))
    return planes_result(graph, params, query, dg, out)
