"""Round-based batched POA across many independent instances.

One POA instance (align reads 1..n of one window onto its growing DAG) is
far too small to fill a device, and the graph-fusion step between reads is
inherently sequential per instance (ref abpoa_poa, src/abpoa_align.c:302-344,
re-toposorts after every read). Throughput therefore comes from batching
ACROSS instances, round-synchronously:

    round r:  [device]  banded DP sweep + backtrack walk of read r of every
                        live instance, one call per shape bucket
              [host]    replay of the packed step stream through the C
                        fusion (NativeGraph.fuse_steps) + re-toposort

Only the ``misc`` row and the packed int32 step stream leave the device.
The DP end is chosen from the platform and the input
(align/engine_jax.pick_engine / round_kind): the banded GPU kernel
(ops/dp_band.py) on a GPU, the plain XLA reference elsewhere; local mode
fetches the XLA planes for the host backtrack. Graph bookkeeping stays on
the host: it is O(V+E) with tiny constants vs the O(V·W) DP (SURVEY.md §7
design delta #5).

Optionally shards the batch axis over a jax.sharding.Mesh (pure data
parallelism: instances are independent, so no collectives are needed in
the DP itself; results gather on fetch).
"""
from __future__ import annotations

import time

import numpy as np

from ..api import ABPOA
from ..params import Params, SRC_NODE_ID, SINK_NODE_ID
from ..align.engine_jax import (export_dense, repad_dense, planes_result,
                                _bucket, pick_engine, round_kind,
                                device_round)
from ..ops import layout as L


def _make_aligners(instances, params, init=None):
    """One ABPOA per instance, graph store backed by the native C core
    when available (same semantics as the Python store; equivalence is
    enforced by tests/test_native_graph.py).

    init(ab), when given, seeds each aligner's starting state before any
    read fuses — the batched analog of the serial loop's incremental
    restore (-i, ref abpoa_restore_graph src/abpoa_seq.c:595-660).
    Returns (aligners, read_id_offsets): new reads number from each
    instance's existing read count, exactly like the serial msa()."""
    from ..graph import NativeGraph
    abs_ = [ABPOA() for _ in instances]
    if NativeGraph.available():
        for ab in abs_:
            ab.graph = NativeGraph()
    rid0 = []
    for ab, reads in zip(abs_, instances):
        if init is not None:
            init(ab)
        exist = ab.n_seq
        rid0.append(exist)
        ab.n_seq = exist + len(reads)
        ab.names = list(ab.names) + [""] * len(reads)
        ab.is_rc = list(ab.is_rc) + [0] * len(reads)
        if NativeGraph.available():
            ab.graph.ensure_reads(ab.n_seq)
    return abs_, rid0


_DISPATCH_POOL = None
_HOST_POOL = None


def _host_pool():
    """Shared pool for per-instance host work whose hot path is one C call
    through ctypes (step fusion, consensus, seeded windows): ctypes
    releases the GIL, so instance-level threading runs in parallel. Graph
    export is mostly small numpy calls and runs faster serially."""
    global _HOST_POOL
    if _HOST_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor
        _HOST_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4),
            thread_name_prefix="abpoa-host")
    return _HOST_POOL


def _dispatch_pool():
    """One shared pool for in-flight device rounds (BatchPOA objects are
    created per run; per-object executors would leak threads)."""
    global _DISPATCH_POOL
    if _DISPATCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _DISPATCH_POOL = ThreadPoolExecutor(
            max_workers=BatchPOA.N_SHARDS,
            thread_name_prefix="abpoa-dispatch")
    return _DISPATCH_POOL


class BatchPOA:
    """Run many independent POA problems through the batched device DP.

    instances: list of problems; each problem is a list of encoded reads
    (uint8 codes). Returns the list of ABPOA aligner states (call
    generate_consensus / output on them like the single-instance API).

    engine: None picks the DP end from the platform (the banded kernel on a
    GPU, the XLA reference elsewhere); "xla" forces the reference; "kernel"
    asks for the kernel, which off a GPU needs interpret=True (tests).
    """

    N_SHARDS = 4

    def __init__(self, params: Params, mesh=None, batch_axis: str = "data",
                 engine: str | None = None, pipeline: bool = True,
                 interpret: bool = False):
        import jax
        self.params = params
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.interpret = interpret
        self.engine = pick_engine(engine, interpret)
        gpu = jax.default_backend() == "gpu"
        # overlap host fusion with device rounds where a device runs them
        self.pipeline = pipeline and gpu
        # seeded window rounds batch on the device on a GPU or a mesh; a
        # CPU run without a mesh keeps the host oracle (compile cost beats
        # the win at test scale)
        self.seeded_device = gpu or mesh is not None
        self.dp_cells = 0          # aggregate band cells computed on device
        self.dp_seconds = 0.0      # device wall time of DP calls (summed;
                                   #  overlapped shards can exceed wall)
        self.dp_intervals = []     # (t0, t1) per device call, for a
                                   #  non-overlapping busy-time union
        self.fallbacks = 0         # instances re-run on the host oracle
        self.rounds = 0
        # host wall seconds: graph export, waiting on device rounds,
        # step replay + fusion
        self.host_seconds = {"export": 0.0, "wait": 0.0, "fuse": 0.0}
        self._weights = None       # per-instance per-read qv weights
        self._rid0 = []            # per-instance read-id offset (-i)

    # -------------------------------------------------------------- #
    def _planes_round(self, dgs):
        """XLA planes round (local mode, R > 4096, seeded windows): the DP
        planes come back for the host backtrack."""
        import jax
        t0 = time.perf_counter()
        out = jax.device_get(device_round("planes", dgs, self.params,
                                          self.mesh, self.batch_axis))
        t1 = time.perf_counter()
        self.dp_seconds += t1 - t0
        self.dp_intervals.append((t0, t1))
        self.dp_cells += int(out.n_cells.sum())
        return out

    def _weight(self, k, r, q):
        """Per-base fusion weights of instance k's read r (qv weights when
        provided, ref abpoa_msa src/abpoa_align.c:373-437; else unit)."""
        if self._weights is not None and self._weights[k] is not None:
            return self._weights[k][r]
        return [1] * len(q)

    def _rid(self, k, r) -> int:
        """Global read id: instance k's existing reads (incremental
        restore) come first, new reads number after them."""
        return self._rid0[k] + r

    def run(self, instances, weights=None, init=None) -> list[ABPOA]:
        self._weights = weights
        abs_, self._rid0 = _make_aligners(instances, self.params, init)
        if self.pipeline and len(instances) >= 4:
            self._run_pipelined(abs_, instances)
            return abs_
        n_rounds = max((len(r) for r in instances), default=0)
        for r in range(n_rounds):
            live = [k for k, reads in enumerate(instances) if r < len(reads)]
            for pend in self._dispatch_round(abs_, live, r, instances):
                self._collect(pend)
            self.rounds += 1
        return abs_

    def _dispatch_round(self, abs_, live, r, instances):
        """Round r for the live instances: first reads fuse straight into
        their empty graphs; the rest export (two passes: natural buckets,
        then re-pad to the group maxima), group by lane width and go to the
        device. Returns the pending device rounds."""
        params = self.params
        todo = []
        for k in live:
            ab, q = abs_[k], instances[k][r]
            if ab.graph.node_n <= 2:
                ab.graph.add_graph_alignment(params, q, self._weight(k, r, q),
                                             [], None, self._rid(k, r), True)
            else:
                todo.append(k)
        if not todo:
            return []

        def sort_export(k):
            g = abs_[k].graph
            if not g.is_topological_sorted:
                g.topological_sort(params)
            return export_dense(g, params, instances[k][r])
        t0 = time.perf_counter()
        nat = {k: sort_export(k) for k in todo}
        self.host_seconds["export"] += time.perf_counter() - t0
        R = max(d.R for d in nat.values())
        W = max(d.W for d in nat.values())
        P_ = max(d.P for d in nat.values())
        O_ = max(d.O for d in nat.values())
        pends = []
        for pn in sorted({d.pn for d in nat.values()}):
            group = [k for k in todo if nat[k].pn == pn]
            dgs = [repad_dense(nat[k], R, W, P_, O_) for k in group]
            pend = self._dispatch(abs_, group, dgs, r, instances)
            if pend is not None:
                pends.append(pend)
        return pends

    def _run_pipelined(self, abs_, instances):
        """Multi-shard software pipeline: the instance list splits into S
        shards; each shard's round is prepared on the main thread, its
        device call and result fetch run on a worker thread, while the main
        thread fuses whichever shard's results arrived first. The device
        works on S-1 rounds while the host fuses one."""
        from collections import deque
        n = len(instances)
        S = min(self.N_SHARDS, max(1, n // 4))
        shards = [list(range(s, n, S)) for s in range(S)]
        rounds = [0] * S
        n_rounds = [max((len(instances[k]) for k in s), default=0)
                    for s in shards]
        pending = [None] * S
        fifo = deque()
        while True:
            for s in range(S):
                if pending[s] is None and rounds[s] < n_rounds[s]:
                    r = rounds[s]
                    live = [k for k in shards[s] if r < len(instances[k])]
                    pending[s] = self._dispatch_round(abs_, live, r,
                                                      instances)
                    rounds[s] += 1
                    fifo.append(s)
                    self.rounds += 1
            if not fifo:
                break
            s = fifo.popleft()
            for pend in pending[s]:
                self._collect(pend)
            pending[s] = None

    # -------------------------------------------------------------- #
    def _dispatch(self, abs_, group, dgs, r, instances):
        """Enqueue one round group's device work (DP sweep + walk) on a
        worker thread and return a pending handle, so the host can fuse
        other instances meanwhile. Local-mode groups (planes round) run
        inline and return None."""
        import jax
        kind = round_kind(self.engine, dgs, self.params)
        if kind == "planes":
            out = self._planes_round(dgs)
            self._finish_round(abs_, group, dgs, out, r, instances)
            return None
        pend = dict(abs_=abs_, group=group, r=r, instances=instances,
                    t0=time.perf_counter())

        def submit():
            return jax.device_get(device_round(
                kind, dgs, self.params, self.mesh, self.batch_axis,
                self.interpret))
        pend["future"] = _dispatch_pool().submit(submit)
        return pend

    def _collect(self, pend):
        """Fetch a dispatched round's results and fuse them (host work)."""
        from ..align.engine_jax import replay_result
        from ..align.engine_np import align_sequence_to_subgraph
        from ..graph import NativeGraph
        params = self.params
        tw = time.perf_counter()
        misc, steps = pend["future"].result()
        abs_, group, r = pend["abs_"], pend["group"], pend["r"]
        instances = pend["instances"]
        t1 = time.perf_counter()
        self.host_seconds["wait"] += t1 - tw
        self.dp_seconds += t1 - pend["t0"]
        self.dp_intervals.append((pend["t0"], t1))
        self.dp_cells += int(misc[:, L.M_CELLS].sum())
        bads = []

        def fuse_one(b_k):
            b, k = b_k
            ab = abs_[k]
            q = instances[k][r]
            w = self._weight(k, r, q)
            rid = self._rid(k, r)
            bad = bool(misc[b, L.M_OVFL] or misc[b, L.M_FAIL])
            if params.amb_strand and (
                    bad or self._amb_flagged(ab, q, int(misc[b, L.M_BEST]))):
                # rc-retry candidate: redo fwd+rc through the sequential
                # per-read body (bit-equal to the device fwd by the
                # engine equivalence chain), ref abpoa_align.c:315
                ab.poa_one(params, q, w, rid)
                return
            if bad:
                bads.append(k)
                res = align_sequence_to_subgraph(
                    ab.graph, params, SRC_NODE_ID, SINK_NODE_ID, q,
                    arena=ab.arena)
            elif isinstance(ab.graph, NativeGraph) and not params.rev_cigar:
                # replay the step stream and fuse it in one C pass, no
                # Python cigar materialization
                ab.graph.fuse_steps(params, 0, steps[b],
                                    int(misc[b, L.M_NSTEPS]),
                                    int(misc[b, L.M_BJ]),
                                    int(misc[b, L.M_ENDJ]), q, rid, True,
                                    weight=(None if self._weights is None
                                            else w))
                return
            else:
                res = replay_result(ab.graph, params, q, misc[b], steps[b])
            ab.graph.add_graph_alignment(params, q, w, res.cigar, None, rid,
                                         True)

        # instance-parallel fusion: each b mutates a different graph, and
        # the hot path is one C call (GIL released)
        list(_host_pool().map(fuse_one, enumerate(group)))
        self.fallbacks += len(bads)
        self.host_seconds["fuse"] += time.perf_counter() - t1

    # -------------------------------------------------------------- #
    def run_seeded(self, instances, weights=None, init=None) -> list[ABPOA]:
        """Batched seeded/progressive POA (the reference's -S/-p mode,
        ref abpoa_anchor_poa src/abpoa_align.c:192-299): minimizer seeding,
        guide tree and chaining run host-side per instance; the per-window
        subgraph alignments batch across instances each round, driving the
        same anchor_poa_requests generator as the sequential path."""
        from ..seed import build_guide_tree_partition
        from ..align.engine_jax import export_dense
        from ..align.engine_np import align_sequence_to_subgraph
        params = self.params
        self._weights = weights
        abs_, self._rid0 = _make_aligners(instances, params, init)
        gens = []
        reqs = {}
        for k, reads in enumerate(instances):
            ab = abs_[k]
            seq_lens = [len(q) for q in reads]
            ws = [self._weight(k, r, q) for r, q in enumerate(reads)]
            rmap, par_anchors, par_c = build_guide_tree_partition(
                reads, seq_lens, params)
            gen = ab.anchor_poa_requests(params, reads, ws, seq_lens,
                                         par_anchors, par_c, rmap,
                                         self._rid0[k])
            gens.append(gen)
            try:
                reqs[k] = next(gen)
            except StopIteration:
                pass
        # window rounds batch through the XLA engine: it consumes the
        # subgraph exports (filtered adjacency + rowmask) directly
        use_xla = self.seeded_device
        # static-shape caps: window qlen is bounded by the longest read,
        # and R/P/O floors ratchet monotonically — without them the
        # per-round maxima drift and every round compiles a fresh kernel
        self._seed_wq_cap = max(
            ((max((len(q) for reads in instances for q in reads),
                  default=0) // 128) + 1) * 128, 128)
        self._seed_floors = {}
        # two interleaved shard groups: while one group's device round is
        # in flight (device call + fetch on a worker thread), the other
        # group's host work (oracle windows, window fusion, next chaining
        # step) runs on the main thread + host pool
        S = 2 if (use_xla and len(instances) >= 8) else 1
        shard_reqs = [{k: v for k, v in reqs.items() if k % S == s}
                      for s in range(S)]
        pending = [None] * S

        def prep_one(rq, k):
            beg_id, end_id, window = rq[k]
            g = abs_[k].graph
            if g.node_n <= 2:
                return k, None
            if not g.is_topological_sorted:
                g.topological_sort(params)
            if not use_xla or len(window) == 0:
                return k, None
            bi = int(g.node_id_to_index[beg_id])
            ei = int(g.node_id_to_index[end_id])
            if ei - bi + 1 > L.MAX_ROWS or len(window) + 1 >= L.MAX_COLS:
                # a window past the device capacity: its full-width planes
                # would not fit; counted as an oracle re-run
                return k, "oracle"
            dg = export_dense(g, params, window, beg_index=bi,
                              end_index=ei)
            return k, (k, beg_id, end_id, window, dg)

        def oracle_one(rq, k):
            beg_id, end_id, window = rq[k]
            g = abs_[k].graph
            if g.node_n <= 2:
                return k, None
            return k, align_sequence_to_subgraph(
                g, params, beg_id, end_id, window, arena=abs_[k].arena)

        while any(shard_reqs) or any(p is not None for p in pending):
            for s in range(S):
                if pending[s] is None and shard_reqs[s]:
                    rq = shard_reqs[s]
                    batch = []
                    host_only = []
                    for k, item in _host_pool().map(
                            lambda k: prep_one(rq, k), sorted(rq)):
                        if item is None or item == "oracle":
                            self.fallbacks += item == "oracle"
                            host_only.append(k)
                        else:
                            batch.append(item)
                    pends = self._seeded_dispatch_xla(batch) if batch else []
                    pending[s] = (rq, pends, host_only)
                    self.rounds += 1
            for s in range(S):
                if pending[s] is not None:
                    rq, pends, host_only = pending[s]
                    results = dict(_host_pool().map(
                        lambda k: oracle_one(rq, k), host_only))
                    for pend in pends:
                        results.update(self._seeded_apply_xla(pend, abs_))

                    def advance(k):
                        try:
                            return k, gens[k].send(results[k]), True
                        except StopIteration:
                            return k, None, False
                    new_rq = {}
                    for k, v, ok in _host_pool().map(advance, sorted(rq)):
                        if ok:
                            new_rq[k] = v
                    shard_reqs[s] = new_rq
                    pending[s] = None
                    break
        return abs_

    def _ratchet_floors(self, pn, items):
        """Ratcheting padded-shape floors per pn: padded dims only grow,
        bounding the number of distinct compiled programs. R starts at the query-scale
        bucket (graphs grow to ~qlen rows, and the row sweep is bounded
        by live rows, so padding R only costs plane memory — not a new
        compile per growth step)."""
        fl = self._seed_floors.setdefault(
            pn, [min(_bucket(self._seed_wq_cap, 64), 4096), 256, 2, 2])
        fl[0] = max(fl[0], max(d[4].R for d in items))
        fl[1] = max(fl[1], max(d[4].W for d in items))
        fl[2] = max(fl[2], max(d[4].P for d in items))
        fl[3] = max(fl[3], max(d[4].O for d in items))
        return tuple(fl)

    def _seeded_dispatch_xla(self, batch):
        """Window rounds on the XLA engine (dp_xla.banded_poa_dp_batch):
        the subgraph exports feed the batched banded DP — filtered
        adjacency keeps dead rows disconnected, and the band writeback is
        masked by the reachability rowmask. The worker thread owns the
        device call and the fetch, so the round loop overlaps them with the
        other shard's host work."""
        params = self.params
        by_pn = {}
        for item in batch:
            by_pn.setdefault(item[4].pn, []).append(item)
        pends = []
        for pn, items in by_pn.items():
            R, W, P_, O_ = self._ratchet_floors(pn, items)
            dgs = [repad_dense(d[4], R, W, P_, O_) for d in items]
            pends.append(dict(future=_dispatch_pool().submit(
                self._planes_round, dgs), items=items, dgs=dgs))
        return pends

    def _seeded_apply_xla(self, pend, abs_):
        """Unpack one XLA window chunk: masked band-state writeback +
        host backtrack from the fetched planes (subgraph-aware via
        dg.beg_index)."""
        out = pend["future"].result()
        return {item[0]: planes_result(abs_[item[0]].graph, self.params,
                                       item[3], dg, out, b)
                for b, (item, dg) in enumerate(zip(pend["items"],
                                                    pend["dgs"]))}

    def _amb_flagged(self, ab, q, score: int) -> bool:
        """Ambiguous-strand retry threshold (ref abpoa_align.c:315)."""
        thres = (min(len(q), ab.graph.node_n - 2)
                 * self.params.max_mat * .3333)
        return score < thres

    def _finish_round(self, abs_, group, dgs, out, r, instances):
        params = self.params
        for b, k in enumerate(group):
            ab = abs_[k]
            q = instances[k][r]
            if params.amb_strand and self._amb_flagged(
                    ab, q, int(out.best_score[b])):
                # before the band-state writeback: the sequential rc-retry
                # reruns the fwd align from the pre-align band state
                ab.poa_one(params, q, self._weight(k, r, q),
                           self._rid(k, r))
                continue
            res = planes_result(ab.graph, params, q, dgs[b], out, b)
            ab.graph.add_graph_alignment(params, q, self._weight(k, r, q),
                                         res.cigar, None, self._rid(k, r),
                                         True)

    def dp_busy_seconds(self) -> float:
        """Union length of the device-call intervals (the summed
        dp_seconds double-counts overlapped pipeline shards)."""
        total = 0.0
        end = float("-inf")
        for t0, t1 in sorted(self.dp_intervals):
            if t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def run_consensus(self, instances, seeded=False, weights=None):
        """Full pipeline: batched POA then consensus per instance; returns
        list of consensus strings (heaviest bundling, max_n_cons=1).
        seeded=True routes through the windowed -S/-p pipeline."""
        from ..consensus import generate_consensus
        from ..alphabet import decode_table
        abs_ = (self.run_seeded(instances, weights=weights) if seeded
                else self.run(instances, weights=weights))
        tab = decode_table(self.params.m)

        def cons_one(ab):
            # instance-independent; heaviest-bundling runs C/numpy work
            # that releases the GIL, so the pool gives real parallelism
            generate_consensus(ab, self.params)
            c = ab.cons
            return [bytes(tab[b] for b in seq).decode()
                    for seq in c.cons_base[:c.n_cons]]
        return list(_host_pool().map(cons_one, abs_))


def batch_msa_from_files(params, fns, out):
    """Batched CLI list mode (-l): one POA instance per input file through
    BatchPOA, outputs rendered in file order — byte-identical to running
    abpoa_msa1 serially per file (the reference processes list entries
    one by one, src/abpoa_align.c:439-503; batching across files is what
    fills the device). Covers qv weights (-Q fastq, ref abpoa.c:135-138)
    and incremental graphs (-i, every instance restores the same initial
    graph before its reads fuse)."""
    from ..seqio import read_seqs
    from ..alphabet import encode_table
    from ..params import GLOBAL_MODE
    tab = encode_table(params.m)
    instances = []
    names = []
    weights = None
    if params.use_qv:
        weights = []
    for fn in fns:
        recs = read_seqs(fn)
        names.append([r.name for r in recs])
        instances.append([
            tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in recs])
        if weights is not None:
            weights.append([
                [ord(c) - 32 for c in r.qual] if r.qual
                else [1] * len(r.seq) for r in recs])
    # serial parity: msa() returns before restore/output on an empty seq
    # list (api.py:196-198, ref abpoa_msa src/abpoa_align.c:373-437 via a
    # 0-iteration read loop) — an empty input file must produce NO output
    keep = [k for k, inst in enumerate(instances) if inst]
    instances = [instances[k] for k in keep]
    names = [names[k] for k in keep]
    if weights is not None:
        weights = [weights[k] for k in keep]
    if not instances:
        return
    init = None
    if params.incr_fn:
        from ..gfa import restore_graph

        def init(ab):
            restore_graph(ab, params)
    bp = BatchPOA(params)
    seeded = (not (params.disable_seeding and not params.progressive_poa)
              and params.align_mode == GLOBAL_MODE)
    abs_ = (bp.run_seeded(instances, weights=weights, init=init) if seeded
            else bp.run(instances, weights=weights, init=init))
    for ab, nm in zip(abs_, names):
        # restored reads (incremental) keep their names; new reads take
        # the input file's record names
        ab.names = list(ab.names[:ab.n_seq - len(nm)]) + nm
        ab.output(params, out)
