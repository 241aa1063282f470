#!/usr/bin/env python3
"""Quickest proof that the batched POA path runs on the GPU.

    python3 chip_smoke.py            # kernel, e2e and cli phases, one card
    python3 chip_smoke.py --four     # only the 4-card mesh phase

Phases (one process, one card; every comparison is exact, the DP is integer):

  kernel  compile the banded DP kernel (ops/dp_band.py) at the e2e batch's
          bucket, print its memory analysis, and compare one round's misc
          rows and step streams for 64 instances against the XLA end and
          the host oracle's cigars.
  e2e     BatchPOA.run_consensus over 1024 windows built from
          tests/data/heter.fa: each a seeded order of a seeded subset of
          10-15 reads, every 64th the whole file in order (must equal the
          abPOA golden); a seeded sample of 32 others must equal the host
          oracle; no oracle re-runs. Prints windows/s, DP cells/s, cold and
          warm wall time.
  cli     ``--engine jax -l`` over 8 files, diffed against the goldens
          (cli.main in this process: a second process could not get memory
          on the card this one holds).
  four    (--four only) the same windows over a 1-D mesh of four cards.

The last stdout line is one JSON object with the device JAX reports. Exits
non-zero, printing no result, without a GPU or without the package beside
this script.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
GOLDEN = REPO / "tests" / "golden_sanitized"


def log(*a):
    print(*a, flush=True)


def heter_reads():
    import numpy as np
    from abpoa_tpu.alphabet import encode_table
    from abpoa_tpu.seqio import read_seqs
    tab = encode_table(5)
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / "heter.fa"))]


def make_windows(reads, n, seed):
    """Every 64th window is the whole file in order; the rest are seeded
    orders of seeded subsets of 10-15 reads."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wins = []
    for i in range(n):
        if i % 64 == 0:
            wins.append(list(reads))
        else:
            k = int(rng.integers(10, 16))
            wins.append([reads[j] for j in rng.permutation(len(reads))[:k]])
    return wins


def golden_cons(name):
    lines = (GOLDEN / name).read_text().split("\n")
    return [ln for ln in lines if ln and not ln.startswith(">")]


def oracle_cons(reads, params):
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.alphabet import decode_table
    from abpoa_tpu.consensus import generate_consensus
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    ab.poa(params, reads, [[1] * len(q) for q in reads], 0)
    generate_consensus(ab, params)
    tab = decode_table(params.m)
    return [bytes(tab[b] for b in s).decode()
            for s in ab.cons.cons_base[:ab.cons.n_cons]]


def check_windows(wins, cons, params, seed):
    """Golden parity of the whole-file windows, oracle parity of a seeded
    sample of 32 others."""
    import numpy as np
    gold = golden_cons("heter_cons.fa")
    for i in range(0, len(wins), 64):
        assert cons[i] == gold, f"window {i} differs from the golden"
    others = [i for i in range(len(wins)) if i % 64]
    rng = np.random.default_rng(seed + 1)
    sample = rng.choice(others, size=min(32, len(others)), replace=False)
    for i in sample:
        assert cons[i] == oracle_cons(wins[i], params), \
            f"window {i} differs from the host oracle"
    return len(range(0, len(wins), 64)), len(sample)


def phase_kernel(params, wins):
    import jax
    import numpy as np
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.align.engine_jax import (export_dense, repad_dense,
                                            kernel_inputs, device_round,
                                            replay_result)
    from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
    from abpoa_tpu.ops import layout as L
    from abpoa_tpu.ops.dp_band import band_dp_batch
    from abpoa_tpu.params import SRC_NODE_ID, SINK_NODE_ID
    # one mid-run round: graphs of each window's first reads (host
    # oracle), the next read as the query
    graphs, dgs, queries = [], [], []
    for reads in wins[:64]:
        n = min(len(reads) - 1, 9)
        ab = ABPOA()
        ab.n_seq = n + 1
        ab.names = [""] * (n + 1)
        ab.is_rc = [0] * (n + 1)
        ab.poa(params, reads[:n], [[1] * len(q) for q in reads[:n]], 0)
        ab.graph.topological_sort(params)
        graphs.append(ab.graph)
        queries.append(reads[n])
        dgs.append(export_dense(ab.graph, params, reads[n]))
    R = max(d.R for d in dgs)
    W = max(d.W for d in dgs)
    P = max(d.P for d in dgs)
    O = max(d.O for d in dgs)
    dgs = [repad_dense(d, R, W, P, O) for d in dgs]
    cfg, arrs = kernel_inputs(dgs, params)
    log(f"kernel: bucket R={cfg.R} WB={cfg.WB} Wq={cfg.Wq} P={cfg.P} "
        f"pn={cfg.pn} lmax={cfg.lmax}")
    t0 = time.perf_counter()
    compiled = jax.jit(lambda *a: band_dp_batch(cfg, *a)).lower(
        *arrs).compile()
    log(f"kernel: compiled in {time.perf_counter() - t0:.3f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    mk, sk = jax.device_get(device_round("kernel", dgs, params))
    mx, sx = jax.device_get(device_round("xla", dgs, params))
    keys = [L.M_BEST, L.M_BI, L.M_BJ, L.M_CELLS, L.M_NSTEPS, L.M_FAIL,
            L.M_ENDI, L.M_ENDJ]
    assert not mk[:, L.M_OVFL].any(), "band overflow in the kernel phase"
    assert (mk[:, keys] == mx[:, keys]).all(), "misc: kernel != XLA end"
    for b in range(len(dgs)):
        n = int(mk[b, L.M_NSTEPS])
        assert (sk[b, :n] == sx[b, :n]).all(), f"steps differ, instance {b}"
        got = replay_result(graphs[b], params, queries[b], mk[b], sk[b])
        ref = align_sequence_to_subgraph(graphs[b], params, SRC_NODE_ID,
                                         SINK_NODE_ID, queries[b])
        assert got.best_score == ref.best_score and got.cigar == ref.cigar, \
            f"instance {b}: kernel cigar differs from the host oracle"
    log(f"kernel: 64 instances equal to the XLA end and the host oracle "
        f"({int(mk[:, L.M_CELLS].sum())} cells)")


def run_e2e(params, wins, mesh=None, reps=3):
    from abpoa_tpu.parallel import BatchPOA
    times = []
    cells = 0
    cons = None
    for rep in range(reps + 1):
        bp = BatchPOA(params, mesh=mesh)
        t0 = time.perf_counter()
        out = bp.run_consensus(wins)
        dt = time.perf_counter() - t0
        assert bp.fallbacks == 0, f"{bp.fallbacks} oracle re-runs"
        times.append(dt)
        cells = bp.dp_cells
        assert cons is None or out == cons, "output differs between runs"
        cons = out
    warm = statistics.median(times[1:])
    log(f"e2e: {len(wins)} windows; cold {times[0]:.3f} s (compile "
        f"included); warm {['%.3f' % t for t in times[1:]]} s, median "
        f"{warm:.3f} s; {len(wins) / warm:.1f} windows/s; "
        f"{cells / warm:.4g} DP cells/s ({cells} cells)")
    return cons


def phase_cli(tmp):
    from abpoa_tpu import cli
    files = [DATA / ("seq.fa" if i % 2 == 0 else "heter.fa")
             for i in range(8)]
    lst = tmp / "files.txt"
    lst.write_text("".join(f"{f}\n" for f in files))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--engine", "jax", "-l", str(lst)])
    assert rc == 0, f"cli exit code {rc}"
    want = "".join((GOLDEN / ("seq_cons.fa" if i % 2 == 0
                              else "heter_cons.fa")).read_text()
                   for i in range(8))
    assert buf.getvalue() == want, "cli -l output differs from the goldens"
    log(f"cli: 8 files equal to the goldens "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_four(params, wins):
    import jax
    from abpoa_tpu.align.engine_jax import (export_dense, device_round)
    from abpoa_tpu.ops import layout as L
    from abpoa_tpu.parallel.multihost import _local_mesh
    mesh = _local_mesh()
    assert mesh is not None and mesh.size == 4, "--four needs 4 devices"
    log(f"four: mesh {dict(mesh.shape)} over "
        f"{[d.id for d in mesh.devices.flat]}")
    # shard placement of one 64-instance round
    from abpoa_tpu.api import ABPOA
    dgs = []
    for reads in wins[:64]:
        ab = ABPOA()
        ab.n_seq = 3
        ab.names = [""] * 3
        ab.is_rc = [0] * 3
        ab.poa(params, reads[:2], [[1] * len(q) for q in reads[:2]], 0)
        ab.graph.topological_sort(params)
        dgs.append(export_dense(ab.graph, params, reads[2], force_R=1024,
                                force_W=1024, force_P=4, force_O=4))
    misc, _ = device_round("kernel", dgs, params, mesh=mesh)
    for s in misc.addressable_shards:
        log(f"four: device {s.device.id}: {s.data.shape[0]} instances, "
            f"{int(jax.device_get(s.data)[:, L.M_CELLS].sum())} cells")
    cons = run_e2e(params, wins, mesh=mesh)
    for d in jax.devices():
        log(f"four: device {d.id} peak bytes in use "
            f"{(d.memory_stats() or {}).get('peak_bytes_in_use')}")
    return cons


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args()
    if not (REPO / "abpoa_tpu").is_dir():
        print("chip_smoke: the abpoa_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    from abpoa_tpu.jaxcache import enable_compile_cache
    from abpoa_tpu.graph import NativeGraph
    from abpoa_tpu.params import Params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"card: {smi.stdout.strip()}")
    log(f"compile cache: {enable_compile_cache()}")
    assert NativeGraph.available(), "the C host graph library did not load"
    params = Params().post_set()
    wins = make_windows(heter_reads(), 1024, args.seed)
    t_all = time.perf_counter()
    if args.four:
        cons = phase_four(params, wins)
        ng, no = check_windows(wins, cons, params, args.seed)
        log(f"four: {ng} golden windows and {no} oracle windows equal")
    else:
        import tempfile
        phase_kernel(params, wins)
        cons = run_e2e(params, wins)
        ng, no = check_windows(wins, cons, params, args.seed)
        log(f"e2e: {ng} golden windows and {no} oracle windows equal")
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(pathlib.Path(tmp))
    log(f"all phases passed in {time.perf_counter() - t_all:.3f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
