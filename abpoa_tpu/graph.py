"""Partial-order alignment graph (host-side DAG store).

Re-design of abPOA's pointer-based abpoa_graph_t
(reference: /root/reference/include/abpoa.h:83-101, src/abpoa_graph.c).

Design notes vs the reference:
  * adjacency stays host-side (graph bookkeeping is O(V+E) and sequential per
    instance; the DP over the graph is the hot path and runs on the device from dense
    arrays exported by ``to_dense()``),
  * per-edge read-id bitmasks are arbitrary-precision python ints instead of
    uint64[] words — identical bit semantics, no word-count bookkeeping,
  * traversal orders (BFS toposort with aligned-node grouping, reverse BFS for
    max_remain, DFS for msa rank) replicate the reference exactly since they
    determine output bytes.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .cigar import CMATCH, CINS, CDEL, CSOFT_CLIP, CHARD_CLIP
from .params import SRC_NODE_ID, SINK_NODE_ID


class Node:
    __slots__ = ("base", "in_id", "out_id", "out_weight", "read_ids",
                 "aligned_node_id", "n_read", "read_weight")

    def __init__(self, base: int = 0):
        self.base = base
        self.in_id: list[int] = []
        self.out_id: list[int] = []
        self.out_weight: list[int] = []
        self.read_ids: list[int] = []      # python-int bitmask per out edge
        self.aligned_node_id: list[int] = []
        self.n_read = 0
        self.read_weight: dict[int, int] = {}  # read_id -> qv weight

    def reset(self):
        self.in_id.clear(); self.out_id.clear(); self.out_weight.clear()
        self.read_ids.clear(); self.aligned_node_id.clear()
        self.n_read = 0
        self.read_weight.clear()


class POAGraph:
    def __init__(self):
        self.node: list[Node] = [Node(), Node()]  # SRC, SINK
        self.is_topological_sorted = False
        self.is_called_cons = False
        self.is_set_msa_rank = False
        self._csr = None  # flat adjacency cache (see build_csr)
        # incremental CSR delta log: new edges / weight bumps / aligned
        # pairs appended since the cache was built (None = log invalid,
        # full rebuild needed)
        self._log = []
        # index maps (filled by topological_sort)
        self.index_to_node_id: np.ndarray | None = None
        self.node_id_to_index: np.ndarray | None = None
        self.node_id_to_max_pos_left: np.ndarray | None = None
        self.node_id_to_max_pos_right: np.ndarray | None = None
        self.node_id_to_max_remain: np.ndarray | None = None
        self.node_id_to_msa_rank: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    @property
    def node_n(self) -> int:
        return len(self.node)

    def reset(self):
        """ref abpoa_reset (src/abpoa_graph.c:681-743): wipe to SRC+SINK."""
        self.node = [Node(), Node()]
        self.is_topological_sorted = self.is_called_cons = False
        self.is_set_msa_rank = False
        self._csr = None
        self._log = []

    def add_node(self, base: int) -> int:
        """ref abpoa_add_graph_node (src/abpoa_graph.c:409-416)."""
        self.node.append(Node(base))
        return len(self.node) - 1

    def add_edge(self, from_id: int, to_id: int, check_edge: bool, w: int,
                 add_read_id: bool, add_read_weight: bool, read_id: int):
        """ref abpoa_add_graph_edge (src/abpoa_graph.c:418-484)."""
        fnode = self.node[from_id]
        log = self._log
        out_edge_i = -1
        if check_edge:
            for i, oid in enumerate(fnode.out_id):
                if oid == to_id:
                    fnode.out_weight[i] += w
                    out_edge_i = i
                    if log is not None:
                        log.append((1, from_id, i, w))
                    break
        if out_edge_i < 0:
            self.node[to_id].in_id.append(from_id)
            fnode.out_id.append(to_id)
            fnode.out_weight.append(w)
            fnode.read_ids.append(0)
            out_edge_i = len(fnode.out_id) - 1
            if log is not None:
                log.append((0, from_id, to_id, w))
        if add_read_id:
            fnode.read_ids[out_edge_i] |= (1 << read_id)
        fnode.n_read += 1
        if add_read_weight:
            fnode.read_weight[read_id] = w

    # --- aligned ("mismatch bundle") nodes, ref src/abpoa_graph.c:377-401 ---
    def get_aligned_id(self, node_id: int, base: int) -> int:
        for aln_id in self.node[node_id].aligned_node_id:
            if self.node[aln_id].base == base:
                return aln_id
        return -1

    def add_aligned_node(self, node_id: int, aligned_id: int):
        node = self.node
        for aid in node[node_id].aligned_node_id:
            node[aid].aligned_node_id.append(aligned_id)
            node[aligned_id].aligned_node_id.append(aid)
        node[node_id].aligned_node_id.append(aligned_id)
        node[aligned_id].aligned_node_id.append(node_id)

    # ------------------------------------------------------------------ #
    def add_graph_sequence(self, seq, weight, qpos_to_node_id,
                           add_read_id: bool, add_read_weight: bool, read_id: int):
        """First read -> linear backbone. ref src/abpoa_graph.c:486-502."""
        seq_l = len(seq)
        last = SRC_NODE_ID
        for i in range(seq_l):
            cur = self.add_node(int(seq[i]))
            if qpos_to_node_id is not None:
                qpos_to_node_id[i] = cur
            self.add_edge(last, cur, False, int(weight[i]), add_read_id,
                          add_read_weight, read_id)
            last = cur
        self.add_edge(last, SINK_NODE_ID, False, int(weight[seq_l - 1]),
                      add_read_id, add_read_weight, read_id)
        self.is_called_cons = self.is_set_msa_rank = False
        self.is_topological_sorted = False

    def add_subgraph_alignment(self, params, beg_node_id: int, end_node_id: int,
                               seq, weight, cigar, qpos_to_node_id, read_id: int,
                               inc_both_ends: bool):
        """Fuse an alignment (graph cigar) into the DAG.

        ref abpoa_add_subgraph_alignment (src/abpoa_graph.c:596-672); fusion
        rules documented at src/abpoa_graph.c:587-593.
        """
        seq_l = len(seq)
        add_read_id = params.use_read_ids
        add_read_weight = params.use_qv and (params.max_n_cons > 1)
        if weight is None:
            weight = [1] * seq_l
        if self.node_n == 2:  # empty graph
            self.add_graph_sequence(seq, weight, qpos_to_node_id,
                                    add_read_id, add_read_weight, read_id)
            return
        if not cigar:
            return

        query_id = -1
        last_new = False
        last_id = beg_node_id
        node = self.node
        rbit = 1 << read_id
        for entry in cigar:
            op = entry[0]
            if op == CMATCH:
                node_id = entry[1]
                query_id += 1
                add = bool(last_id != beg_node_id or inc_both_ends)
                if node[node_id].base != seq[query_id]:  # mismatch
                    aligned_id = self.get_aligned_id(node_id, int(seq[query_id]))
                    if aligned_id != -1:
                        self.add_edge(last_id, aligned_id, not last_new,
                                      int(weight[query_id]), add_read_id and add,
                                      add_read_weight, read_id)
                        last_id = aligned_id; last_new = False
                    else:
                        new_id = self.add_node(int(seq[query_id]))
                        self.add_edge(last_id, new_id, False,
                                      int(weight[query_id]), add_read_id and add,
                                      add_read_weight, read_id)
                        self.add_aligned_node(node_id, new_id)
                        last_id = new_id; last_new = True
                else:  # match: inlined add_edge fast path (the dominant op)
                    w = int(weight[query_id])
                    fnode = node[last_id]
                    out_edge_i = -1
                    if not last_new:
                        for i, oid in enumerate(fnode.out_id):
                            if oid == node_id:
                                fnode.out_weight[i] += w
                                out_edge_i = i
                                if self._log is not None:
                                    self._log.append((1, last_id, i, w))
                                break
                    if out_edge_i < 0:
                        node[node_id].in_id.append(last_id)
                        fnode.out_id.append(node_id)
                        fnode.out_weight.append(w)
                        fnode.read_ids.append(0)
                        out_edge_i = len(fnode.out_id) - 1
                        if self._log is not None:
                            self._log.append((0, last_id, node_id, w))
                    if add_read_id and add:
                        fnode.read_ids[out_edge_i] |= rbit
                    fnode.n_read += 1
                    if add_read_weight:
                        fnode.read_weight[read_id] = w
                    last_id = node_id; last_new = False
                if qpos_to_node_id is not None:
                    qpos_to_node_id[query_id] = last_id
            elif op in (CINS, CSOFT_CLIP, CHARD_CLIP):
                length = entry[2]
                query_id += length
                for j in range(length - 1, -1, -1):
                    new_id = self.add_node(int(seq[query_id - j]))
                    add = bool(last_id != beg_node_id or inc_both_ends)
                    self.add_edge(last_id, new_id, False,
                                  int(weight[query_id - j]), add_read_id and add,
                                  add_read_weight, read_id)
                    last_id = new_id; last_new = True
                    if qpos_to_node_id is not None:
                        qpos_to_node_id[query_id - j] = last_id
            elif op == CDEL:
                continue
        self.add_edge(last_id, end_node_id, not last_new, int(weight[seq_l - 1]),
                      add_read_id, add_read_weight, read_id)
        self.is_called_cons = False
        self.is_topological_sorted = False

    def add_graph_alignment(self, params, seq, weight, cigar, qpos_to_node_id,
                            read_id: int, inc_both_ends: bool):
        self.add_subgraph_alignment(params, SRC_NODE_ID, SINK_NODE_ID, seq,
                                    weight, cigar, qpos_to_node_id, read_id,
                                    inc_both_ends)

    # ------------------------------------------------------------------ #
    def _build_csr_full(self):
        node = self.node
        n = len(node)
        out_cnt = np.fromiter((len(nd.out_id) for nd in node), np.int32, n)
        in_cnt = np.fromiter((len(nd.in_id) for nd in node), np.int32, n)
        out_off = np.zeros(n + 1, np.int32)
        np.cumsum(out_cnt, out=out_off[1:])
        in_off = np.zeros(n + 1, np.int32)
        np.cumsum(in_cnt, out=in_off[1:])
        out_flat = np.fromiter((x for nd in node for x in nd.out_id),
                               np.int32, int(out_off[-1]))
        out_w_flat = np.fromiter((x for nd in node for x in nd.out_weight),
                                 np.int32, int(out_off[-1]))
        in_flat = np.fromiter((x for nd in node for x in nd.in_id),
                              np.int32, int(in_off[-1]))
        bases = np.fromiter((nd.base for nd in node), np.int32, n)
        return {
            "n": n, "out_flat": out_flat, "out_off": out_off,
            "out_w_flat": out_w_flat, "in_flat": in_flat, "in_off": in_off,
            "in_cnt": in_cnt, "out_cnt": out_cnt, "bases": bases,
        }

    def build_csr(self):
        """Flat CSR adjacency snapshot (node-id space) for the native host
        kernels and the device exporter.

        Maintained incrementally: add_edge logs new edges / weight bumps;
        rebuilding scatters the previous snapshot to the new offsets
        (vectorized) and replays only the O(changes) log. Aligned-node
        lists are tiny and rebuilt every time."""
        node = self.node
        n = len(node)
        c = self._csr
        log = self._log
        if c is None or log is None:
            c = self._build_csr_full()
            self._log = []
        elif log or c["n"] != n:
            n0 = c["n"]
            out_cnt = np.zeros(n, np.int32)
            out_cnt[:n0] = c["out_cnt"]
            in_cnt = np.zeros(n, np.int32)
            in_cnt[:n0] = c["in_cnt"]
            for k, a, b, w in log:
                if k == 0:
                    out_cnt[a] += 1
                    in_cnt[b] += 1
            out_off = np.zeros(n + 1, np.int32)
            np.cumsum(out_cnt, out=out_off[1:])
            in_off = np.zeros(n + 1, np.int32)
            np.cumsum(in_cnt, out=in_off[1:])
            out_flat = np.empty(int(out_off[-1]), np.int32)
            out_w_flat = np.empty(int(out_off[-1]), np.int32)
            in_flat = np.empty(int(in_off[-1]), np.int32)
            # scatter the old snapshot to its new positions
            if int(c["out_off"][-1]):
                nodes_of = np.repeat(np.arange(n0, dtype=np.int64),
                                     c["out_cnt"])
                pos = (out_off[:-1][nodes_of]
                       + np.arange(len(nodes_of))
                       - c["out_off"][:-1][nodes_of])
                out_flat[pos] = c["out_flat"]
                out_w_flat[pos] = c["out_w_flat"]
            if int(c["in_off"][-1]):
                nodes_of = np.repeat(np.arange(n0, dtype=np.int64),
                                     c["in_cnt"])
                pos = (in_off[:-1][nodes_of]
                       + np.arange(len(nodes_of))
                       - c["in_off"][:-1][nodes_of])
                in_flat[pos] = c["in_flat"]
            # replay the log in order (appends keep per-node list order)
            out_fill = out_off[:-1] + np.where(
                np.arange(n) < n0,
                np.concatenate((c["out_cnt"], np.zeros(n - n0, np.int32))),
                0).astype(np.int32)
            in_fill = in_off[:-1] + np.where(
                np.arange(n) < n0,
                np.concatenate((c["in_cnt"], np.zeros(n - n0, np.int32))),
                0).astype(np.int32)
            for k, a, b, w in log:
                if k == 0:
                    out_flat[out_fill[a]] = b
                    out_w_flat[out_fill[a]] = w
                    out_fill[a] += 1
                    in_flat[in_fill[b]] = a
                    in_fill[b] += 1
                else:
                    out_w_flat[out_off[a] + b] += w
            bases = np.empty(n, np.int32)
            bases[:n0] = c["bases"]
            for i in range(n0, n):
                bases[i] = node[i].base
            c = {
                "n": n, "out_flat": out_flat, "out_off": out_off,
                "out_w_flat": out_w_flat, "in_flat": in_flat,
                "in_off": in_off, "in_cnt": in_cnt, "out_cnt": out_cnt,
                "bases": bases,
            }
            self._log = []
        # aligned lists: always rebuilt (a handful of entries)
        al_cnt = np.fromiter((len(nd.aligned_node_id) for nd in node),
                             np.int32, n)
        al_off = np.zeros(n + 1, np.int32)
        np.cumsum(al_cnt, out=al_off[1:])
        c["al_flat"] = np.fromiter(
            (x for nd in node for x in nd.aligned_node_id), np.int32,
            int(al_off[-1]))
        c["al_off"] = al_off
        self._csr = c
        return c

    def _bfs_set_node_index(self):
        """Kahn BFS keeping aligned nodes adjacent.
        ref abpoa_BFS_set_node_index (src/abpoa_graph.c:186-231)."""
        n = self.node_n
        in_degree = [len(nd.in_id) for nd in self.node]
        index_to_node_id = np.empty(n, dtype=np.int64)
        node_id_to_index = np.empty(n, dtype=np.int64)
        q = deque([SRC_NODE_ID])
        index = 0
        while q:
            cur = q.popleft()
            index_to_node_id[index] = cur
            node_id_to_index[cur] = index
            index += 1
            if cur == SINK_NODE_ID:
                self.index_to_node_id = index_to_node_id
                self.node_id_to_index = node_id_to_index
                return
            for out_id in self.node[cur].out_id:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    if any(in_degree[a] != 0
                           for a in self.node[out_id].aligned_node_id):
                        continue
                    q.append(out_id)
                    for a in self.node[out_id].aligned_node_id:
                        q.append(a)
        raise RuntimeError("Failed to set node index.")

    def _bfs_set_node_remain(self):
        """Reverse BFS computing longest remaining path along heaviest out edge.
        ref abpoa_BFS_set_node_remain (src/abpoa_graph.c:233-274)."""
        n = self.node_n
        out_degree = [len(nd.out_id) for nd in self.node]
        max_remain = np.zeros(n, dtype=np.int64)
        max_remain[SINK_NODE_ID] = -1
        q = deque([SINK_NODE_ID])
        while q:
            cur = q.popleft()
            if cur != SINK_NODE_ID:
                max_w, max_id = -1, -1
                nd = self.node[cur]
                for out_id, w in zip(nd.out_id, nd.out_weight):
                    if w > max_w:
                        max_w, max_id = w, out_id
                max_remain[cur] = max_remain[max_id] + 1
            if cur == SRC_NODE_ID:
                self.node_id_to_max_remain = max_remain
                return
            for in_id in self.node[cur].in_id:
                out_degree[in_id] -= 1
                if out_degree[in_id] == 0:
                    q.append(in_id)
        raise RuntimeError("Failed to set node remain.")

    def topological_sort(self, params):
        """ref abpoa_topological_sort (src/abpoa_graph.c:279-313).

        Uses the native C kernels (abpoa_tpu.native) when available — exact
        same traversal orders, ~20x less host time per round — with the
        Python BFS as the always-correct fallback."""
        from . import native
        n = self.node_n
        lib = native.get_lib()
        if lib is not None:
            c = self.build_csr()
            i2n, n2i = native.topo_sort(n, c["out_flat"], c["out_off"],
                                        c["in_cnt"], c["al_flat"],
                                        c["al_off"])
            self.index_to_node_id = i2n.astype(np.int64)
            self.node_id_to_index = n2i.astype(np.int64)
        else:
            self._csr = None
            self._bfs_set_node_index()
        if params.wb >= 0 or params.zdrop > 0:
            if lib is not None:
                self.node_id_to_max_remain = native.set_remain(
                    n, c["out_flat"], c["out_off"], c["out_w_flat"],
                    c["in_flat"], c["in_off"], c["out_cnt"]).astype(np.int64)
            else:
                self._bfs_set_node_remain()
        if params.wb >= 0:
            self.node_id_to_max_pos_right = np.zeros(n, dtype=np.int64)
            self.node_id_to_max_pos_left = np.full(n, n, dtype=np.int64)
        self.is_topological_sorted = True

    # ------------------------------------------------------------------ #
    def _dfs_set_msa_rank(self):
        """DFS (LIFO) rank where aligned nodes share one MSA column.
        ref abpoa_DFS_set_msa_rank (src/abpoa_graph.c:315-366)."""
        n = self.node_n
        in_degree = [len(nd.in_id) for nd in self.node]
        msa_rank = np.full(n, -1, dtype=np.int64)
        stack = [SRC_NODE_ID]
        rank = 0
        while stack:
            cur = stack.pop()
            if msa_rank[cur] < 0:
                msa_rank[cur] = rank
                for a in self.node[cur].aligned_node_id:
                    msa_rank[a] = rank
                rank += 1
            if cur == SINK_NODE_ID:
                self.node_id_to_msa_rank = msa_rank
                self.is_set_msa_rank = True
                return
            for out_id in self.node[cur].out_id:
                in_degree[out_id] -= 1
                if in_degree[out_id] == 0:
                    if any(in_degree[a] != 0
                           for a in self.node[out_id].aligned_node_id):
                        continue
                    stack.append(out_id)
                    msa_rank[out_id] = -1
                    for a in self.node[out_id].aligned_node_id:
                        stack.append(a)
                        msa_rank[a] = -1
        raise RuntimeError("Error in set_msa_rank.")

    def set_msa_rank(self):
        if not self.is_set_msa_rank:
            from . import native
            lib = native.get_lib()
            if lib is not None:
                # unconditional: build_csr is O(pending changes) when the
                # delta log is small, and trusting a cached snapshot here
                # would silently use stale adjacency if a future mutation
                # path forgot to clear is_topological_sorted
                c = self.build_csr()
                self.node_id_to_msa_rank = native.msa_rank(
                    self.node_n, c["out_flat"], c["out_off"], c["in_cnt"],
                    c["al_flat"], c["al_off"]).astype(np.int64)
                self.is_set_msa_rank = True
            else:
                self._dfs_set_msa_rank()

    # ------------------------------------------------------------------ #
    # subgraph closure, ref src/abpoa_graph.c:504-585
    def _is_full_upstream(self, up_index: int, down_index: int) -> bool:
        for i in range(up_index + 1, down_index + 1):
            nid = int(self.index_to_node_id[i])
            for in_id in self.node[nid].in_id:
                if self.node_id_to_index[in_id] < up_index:
                    return False
        return True

    def upstream_index(self, beg_index: int, end_index: int) -> int:
        while True:
            min_index = beg_index
            for i in range(beg_index, end_index + 1):
                nid = int(self.index_to_node_id[i])
                for in_id in self.node[nid].in_id:
                    min_index = min(min_index, int(self.node_id_to_index[in_id]))
            if self._is_full_upstream(min_index, beg_index):
                return min_index
            end_index = beg_index
            beg_index = min_index

    def downstream_index(self, beg_index: int, end_index: int) -> int:
        while True:
            max_index = end_index
            for i in range(beg_index, end_index + 1):
                nid = int(self.index_to_node_id[i])
                for out_id in self.node[nid].out_id:
                    max_index = max(max_index, int(self.node_id_to_index[out_id]))
            if self._is_full_upstream(end_index, max_index):
                return max_index
            beg_index = end_index
            end_index = max_index

    def subgraph_nodes(self, params, inc_beg: int, inc_end: int) -> tuple[int, int]:
        """ref abpoa_subgraph_nodes (src/abpoa_graph.c:573-585)."""
        if not self.is_topological_sorted:
            self.topological_sort(params)
        beg_i = int(self.node_id_to_index[inc_beg])
        end_i = int(self.node_id_to_index[inc_end])
        exc_beg_i = self.upstream_index(beg_i, end_i)
        exc_end_i = self.downstream_index(beg_i, end_i)
        return int(self.index_to_node_id[exc_beg_i]), int(self.index_to_node_id[exc_end_i])


class NativeGraph(POAGraph):
    """POAGraph backed by the native C store (native/poagraph.c).

    Same semantics (list orders, fusion rules, traversal orders — all
    byte-parity-critical) with storage, CIGAR/steps fusion, traversals and
    CSR export in C. ``.node`` materializes Python Node views lazily (cached
    per mutation version) for the cold read paths (consensus/MSA/GFA/plot
    and the host oracle); the batched device pipeline never touches it.
    Use ``available()`` to check the C library loaded.
    """

    def __init__(self):
        from . import native
        self._n = native
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.pg_new()
        if not self._h:
            raise MemoryError("pg_new failed")
        self.is_topological_sorted = False
        self.is_called_cons = False
        self.is_set_msa_rank = False
        self._version = 0
        self._csr = None
        self._csr_version = -1
        self._nodes_cache = None
        self._nodes_version = -1
        self._i2n32 = None
        self.index_to_node_id = None
        self.node_id_to_index = None
        self.node_id_to_max_pos_left = None
        self.node_id_to_max_pos_right = None
        self.node_id_to_max_remain = None
        self.node_id_to_msa_rank = None

    @staticmethod
    def available() -> bool:
        from . import native
        return native.get_lib() is not None

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pg_free(h)
            self._h = None

    # ------------------------------------------------------------------ #
    @property
    def node_n(self) -> int:
        return int(self._lib.pg_node_n(self._h))

    @property
    def node(self):
        """Materialized Node views (read-only snapshot, cached)."""
        if self._nodes_version == self._version:
            return self._nodes_cache
        import ctypes
        ptr = self._n.ptr
        lib = self._lib
        c = self.build_csr()
        n = c["n"]
        E = int(c["out_off"][-1])
        rn = int(lib.pg_rn(self._h))
        cnt = (ctypes.c_int64 * 3)()
        lib.pg_counts(self._h, ctypes.byref(cnt, 0), ctypes.byref(cnt, 8),
                      ctypes.byref(cnt, 16))
        n_rw = int(cnt[2])
        read_words = np.zeros((max(E, 1), rn), dtype=np.uint64)
        n_read = np.zeros(n, dtype=np.int32)
        rw_node = np.zeros(max(n_rw, 1), dtype=np.int32)
        rw_rid = np.zeros(max(n_rw, 1), dtype=np.int32)
        rw_w = np.zeros(max(n_rw, 1), dtype=np.int32)
        lib.pg_export_aux(self._h, ptr(read_words), ptr(n_read),
                          ptr(rw_node), ptr(rw_rid), ptr(rw_w))
        out_off = c["out_off"]
        in_off = c["in_off"]
        al_off = c["al_off"]
        out_flat = c["out_flat"]
        out_w = c["out_w_flat"]
        in_flat = c["in_flat"]
        al_flat = c["al_flat"]
        bases = c["bases"]
        rbytes = read_words.view(np.uint8).reshape(max(E, 1), rn * 8)
        nodes = []
        for i in range(n):
            nd = Node(int(bases[i]))
            o0, o1 = int(out_off[i]), int(out_off[i + 1])
            nd.out_id = out_flat[o0:o1].tolist()
            nd.out_weight = out_w[o0:o1].tolist()
            nd.read_ids = [int.from_bytes(rbytes[e], "little")
                           for e in range(o0, o1)]
            nd.in_id = in_flat[int(in_off[i]):int(in_off[i + 1])].tolist()
            nd.aligned_node_id = al_flat[int(al_off[i]):
                                         int(al_off[i + 1])].tolist()
            nd.n_read = int(n_read[i])
            nodes.append(nd)
        for j in range(n_rw):
            nodes[int(rw_node[j])].read_weight[int(rw_rid[j])] = int(rw_w[j])
        self._nodes_cache = nodes
        self._nodes_version = self._version
        return nodes

    # ------------------------------------------------------------------ #
    def _dirty(self):
        self._version += 1
        self.is_called_cons = False
        self.is_set_msa_rank = False
        self.is_topological_sorted = False

    def reset(self):
        self._lib.pg_reset(self._h)
        self._dirty()
        self._csr = None
        self._csr_version = -1
        self._nodes_cache = None
        self._nodes_version = -1

    def add_node(self, base: int) -> int:
        self._version += 1
        nid = int(self._lib.pg_add_node(self._h, int(base)))
        if nid < 0:
            raise MemoryError("pg_add_node failed")
        return nid

    def add_edge(self, from_id: int, to_id: int, check_edge: bool, w: int,
                 add_read_id: bool, add_read_weight: bool, read_id: int):
        self._version += 1
        self._lib.pg_add_edge(self._h, int(from_id), int(to_id),
                              int(check_edge), int(w), int(add_read_id),
                              int(add_read_weight), int(read_id))

    def get_aligned_id(self, node_id: int, base: int) -> int:
        return int(self._lib.pg_get_aligned_id(self._h, int(node_id),
                                               int(base)))

    def add_aligned_node(self, node_id: int, aligned_id: int):
        self._version += 1
        self._lib.pg_add_aligned(self._h, int(node_id), int(aligned_id))

    def ensure_reads(self, n_reads: int):
        """Pre-size per-edge read-id masks (avoids growth re-layouts)."""
        self._lib.pg_ensure_reads(self._h, int(n_reads))

    # ------------------------------------------------------------------ #
    def add_graph_sequence(self, seq, weight, qpos_to_node_id,
                           add_read_id: bool, add_read_weight: bool,
                           read_id: int):
        ptr = self._n.ptr
        seq_l = len(seq)
        s = np.ascontiguousarray(seq, dtype=np.uint8)
        w = np.ascontiguousarray(weight, dtype=np.int32)
        q2n = np.zeros(seq_l, dtype=np.int32) \
            if qpos_to_node_id is not None else None
        rc = self._lib.pg_add_graph_sequence(
            self._h, ptr(s), ptr(w), seq_l,
            ptr(q2n) if q2n is not None else None,
            int(add_read_id), int(add_read_weight), int(read_id))
        if rc != 0:
            raise MemoryError("pg_add_graph_sequence failed")
        if qpos_to_node_id is not None:
            qpos_to_node_id[:seq_l] = q2n.tolist()
        self._dirty()

    def add_subgraph_alignment(self, params, beg_node_id: int,
                               end_node_id: int, seq, weight, cigar,
                               qpos_to_node_id, read_id: int,
                               inc_both_ends: bool):
        ptr = self._n.ptr
        seq_l = len(seq)
        add_read_id = params.use_read_ids
        add_read_weight = params.use_qv and (params.max_n_cons > 1)
        if weight is None:
            weight = [1] * seq_l
        if self.node_n == 2:
            self.add_graph_sequence(seq, weight, qpos_to_node_id,
                                    add_read_id, add_read_weight, read_id)
            return
        if not cigar:
            return
        nc = len(cigar)
        cg = np.asarray(cigar, dtype=np.int64)
        cg_op = np.ascontiguousarray(cg[:, 0], dtype=np.int32)
        cg_a = np.ascontiguousarray(cg[:, 1], dtype=np.int32)
        cg_b = np.ascontiguousarray(cg[:, 2], dtype=np.int32)
        s = np.ascontiguousarray(seq, dtype=np.uint8)
        w = np.ascontiguousarray(weight, dtype=np.int32)
        q2n = np.zeros(seq_l, dtype=np.int32) \
            if qpos_to_node_id is not None else None
        rc = self._lib.pg_add_subgraph_alignment(
            self._h, int(beg_node_id), int(end_node_id), ptr(s), ptr(w),
            seq_l, ptr(cg_op), ptr(cg_a), ptr(cg_b), nc,
            ptr(q2n) if q2n is not None else None,
            int(read_id), int(inc_both_ends), int(add_read_id),
            int(add_read_weight))
        if rc != 0:
            raise MemoryError("pg_add_subgraph_alignment failed")
        if qpos_to_node_id is not None:
            qpos_to_node_id[:seq_l] = q2n.tolist()
        self._version += 1
        self.is_called_cons = False
        self.is_topological_sorted = False

    def fuse_steps(self, params, row0: int, steps, nsteps: int,
                   best_j: int, end_j: int, seq, read_id: int,
                   inc_both_ends: bool,
                   beg_node_id: int = SRC_NODE_ID,
                   end_node_id: int = SINK_NODE_ID, weight=None):
        """Replay a device backtrack step stream and fuse it in one native
        pass (replaces bt_xla.replay_steps + add_graph_alignment when the
        cigar itself is not needed). Requires params.rev_cigar == False."""
        assert not params.rev_cigar
        ptr = self._n.ptr
        qlen = len(seq)
        add_read_id = params.use_read_ids
        add_read_weight = params.use_qv and (params.max_n_cons > 1)
        s = np.ascontiguousarray(seq, dtype=np.uint8)
        if weight is None:
            w = np.ones(qlen, dtype=np.int32)
        else:
            w = np.ascontiguousarray(weight, dtype=np.int32)
        st = np.ascontiguousarray(steps[:nsteps], dtype=np.int32)
        rc = self._lib.pg_fuse_steps(
            self._h, ptr(self._i2n32), int(row0), ptr(st), int(nsteps),
            int(best_j), int(end_j), qlen, ptr(s), ptr(w), int(read_id),
            int(add_read_id), int(add_read_weight), int(inc_both_ends),
            int(beg_node_id), int(end_node_id))
        if rc != 0:
            raise MemoryError("pg_fuse_steps failed")
        self._version += 1
        self.is_called_cons = False
        self.is_topological_sorted = False

    # ------------------------------------------------------------------ #
    def build_csr(self):
        if self._csr is not None and self._csr_version == self._version:
            return self._csr
        import ctypes
        ptr = self._n.ptr
        lib = self._lib
        n = self.node_n
        cnt = (ctypes.c_int64 * 3)()
        lib.pg_counts(self._h, ctypes.byref(cnt, 0), ctypes.byref(cnt, 8),
                      ctypes.byref(cnt, 16))
        E, A = int(cnt[0]), int(cnt[1])
        bases = np.empty(n, dtype=np.int32)
        out_cnt = np.empty(n, dtype=np.int32)
        in_cnt = np.empty(n, dtype=np.int32)
        out_off = np.empty(n + 1, dtype=np.int32)
        in_off = np.empty(n + 1, dtype=np.int32)
        out_flat = np.empty(E, dtype=np.int32)
        out_w_flat = np.empty(E, dtype=np.int32)
        in_flat = np.empty(E, dtype=np.int32)
        al_off = np.empty(n + 1, dtype=np.int32)
        al_flat = np.empty(A, dtype=np.int32)
        lib.pg_export_csr(self._h, ptr(bases), ptr(out_cnt), ptr(in_cnt),
                          ptr(out_off), ptr(in_off), ptr(out_flat),
                          ptr(out_w_flat), ptr(in_flat), ptr(al_off),
                          ptr(al_flat))
        self._csr = {
            "n": n, "out_flat": out_flat, "out_off": out_off,
            "out_w_flat": out_w_flat, "in_flat": in_flat, "in_off": in_off,
            "in_cnt": in_cnt, "out_cnt": out_cnt, "bases": bases,
            "al_flat": al_flat, "al_off": al_off,
        }
        self._csr_version = self._version
        return self._csr

    def topological_sort(self, params):
        ptr = self._n.ptr
        n = self.node_n
        # refresh the CSR snapshot: export_dense consumes graph._csr
        # directly when is_topological_sorted (same contract as POAGraph,
        # whose topological_sort goes through build_csr)
        self.build_csr()
        i2n = np.empty(n, dtype=np.int32)
        n2i = np.empty(n, dtype=np.int32)
        if self._lib.pg_topo_sort(self._h, ptr(i2n), ptr(n2i)) != 0:
            raise RuntimeError("Failed to set node index.")
        self._i2n32 = i2n
        self.index_to_node_id = i2n.astype(np.int64)
        self.node_id_to_index = n2i.astype(np.int64)
        if params.wb >= 0 or params.zdrop > 0:
            remain = np.empty(n, dtype=np.int32)
            if self._lib.pg_set_remain(self._h, ptr(remain)) != 0:
                raise RuntimeError("Failed to set node remain.")
            self.node_id_to_max_remain = remain.astype(np.int64)
        if params.wb >= 0:
            self.node_id_to_max_pos_right = np.zeros(n, dtype=np.int64)
            self.node_id_to_max_pos_left = np.full(n, n, dtype=np.int64)
        self.is_topological_sorted = True

    def set_msa_rank(self):
        if not self.is_set_msa_rank:
            ptr = self._n.ptr
            rank = np.empty(self.node_n, dtype=np.int32)
            if self._lib.pg_msa_rank(self._h, ptr(rank)) != 0:
                raise RuntimeError("Error in set_msa_rank.")
            self.node_id_to_msa_rank = rank.astype(np.int64)
            self.is_set_msa_rank = True
