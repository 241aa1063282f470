#!/usr/bin/env python3
"""Benchmark of the batched POA path on the GPU, end to end.

    python3 bench.py [--windows 1024] [--reps 3] [--seed 0]
                     [--ends kernel,xla] [--seeded 64]

Phases, all on the windows chip_smoke.py builds from tests/data/heter.fa
(seeded subsets of 10-15 reads, every 64th the whole file):

  e2e     BatchPOA.run_consensus with each DP end: ``kernel`` (the banded
          GPU kernel, ops/dp_band.py) and ``xla`` (dp_xla sweep + bt_xla
          walk). One cold run (compiles included, reported as set-up), then
          --reps warm runs: median and spread of the wall time, windows/s,
          DP cells/s, the host's export/wait/fuse seconds, oracle re-runs.
          Both ends must give the same consensus.
  round   device-only time of one DP round at the e2e bucket for each end
          (B = 1024 instances, warm, median of --reps).
  seeded  BatchPOA.run_seeded (-S) over --seeded windows, windows/s.
  trace   one more warm e2e run on the GPU engine under
          jax.profiler: per device stream its busy seconds (the union of its
          events) and the ops that took them, the kernel's own seconds, and
          the compute streams' busy and idle share of the traced wall time
          (the profiler slows the host, so that wall exceeds the e2e one).
          The trace is written under build/ and removed once read.

Prints one JSON line per phase; the last line is the whole record, with the
card's name and power limit. Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import pathlib
import subprocess
import sys
import time

from chip_smoke import REPO, heter_reads, make_windows


def emit(rec):
    print(json.dumps(rec), flush=True)


def e2e(params, wins, engine, reps):
    from abpoa_tpu.parallel import BatchPOA
    runs = []
    cons = None
    for _ in range(reps + 1):
        bp = BatchPOA(params, engine=engine)
        t0 = time.perf_counter()
        out = bp.run_consensus(wins)
        runs.append((time.perf_counter() - t0, bp))
        assert cons is None or out == cons
        cons = out
    warm = [t for t, _ in runs[1:]]
    med = statistics.median(warm)
    bp = runs[-1][1]
    return cons, {
        "end": bp.engine, "windows": len(wins),
        "cold_seconds": runs[0][0], "warm_seconds": warm,
        "warm_median_seconds": med,
        "warm_spread": (max(warm) - min(warm)) / med,
        "windows_per_s": len(wins) / med,
        "dp_cells": bp.dp_cells, "dp_cells_per_s": bp.dp_cells / med,
        "host_seconds": bp.host_seconds, "rounds": bp.rounds,
        "fallbacks": bp.fallbacks}


def round_time(params, wins, kind, reps):
    """One device round (a mid-run graph of each window, its next read)
    at the e2e bucket, device only."""
    import jax
    from abpoa_tpu.api import ABPOA
    from abpoa_tpu.align.engine_jax import (device_round, export_dense,
                                            repad_dense)
    dgs = []
    for reads in wins[:128]:
        ab = ABPOA()
        ab.n_seq, ab.names, ab.is_rc = 10, [""] * 10, [0] * 10
        ab.poa(params, reads[:9], [[1] * len(q) for q in reads[:9]], 0)
        ab.graph.topological_sort(params)
        dgs.append(export_dense(ab.graph, params, reads[9]))
    dims = [max(getattr(d, f) for d in dgs) for f in "RWPO"]
    dgs = [repad_dense(d, *dims) for d in dgs] * 8
    ts = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(device_round(kind, dgs, params))
        ts.append(time.perf_counter() - t0)
    return {"end": kind, "B": len(dgs), "R": dims[0], "W": dims[1],
            "cold_seconds": ts[0], "warm_seconds": ts[1:],
            "warm_median_seconds": statistics.median(ts[1:])}


def seeded(wins, reps):
    from abpoa_tpu.params import Params
    from abpoa_tpu.parallel import BatchPOA
    params = Params()
    params.disable_seeding = 0
    params.post_set()
    ts = []
    for _ in range(reps + 1):
        bp = BatchPOA(params)
        t0 = time.perf_counter()
        bp.run_seeded(wins)
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts[1:])
    return {"windows": len(wins), "cold_seconds": ts[0],
            "warm_seconds": ts[1:], "windows_per_s": len(wins) / med,
            "dp_cells": bp.dp_cells, "fallbacks": bp.fallbacks}


def device_streams(events):
    """Per device stream of a Chrome-format trace: event count, busy seconds
    (the union of its events' intervals), and seconds and launches per op,
    largest first. Returns ({stream: record}, {stream: intervals})."""
    procs, threads = {}, {}
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[e["pid"], e["tid"]] = e["args"]["name"]
        elif e.get("ph") == "X":
            spans[e["pid"], e.get("tid")].append(e)
    recs, ivs = {}, {}
    for (pid, tid), evs in spans.items():
        if not procs.get(pid, "").startswith("/device:"):
            continue
        name = f"{procs[pid]} {threads.get((pid, tid), tid)}"
        ivs[name] = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in evs]
        ops = collections.Counter()
        for e in evs:
            ops[e["name"]] += e.get("dur", 0) / 1e6
        top = [k for k, _ in ops.most_common(5)]
        launches = collections.Counter(e["name"] for e in evs)
        recs[name] = {"events": len(evs),
                      "busy_seconds": union_seconds(ivs[name]),
                      "ops": {k: ops[k] for k in top},
                      "launches": {k: launches[k] for k in top}}
    return recs, ivs


def union_seconds(intervals):
    """Length of the union of (start, end) intervals in microseconds, in
    seconds."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / 1e6


def trace(params, wins):
    import gzip
    import shutil
    import tempfile
    import jax
    from abpoa_tpu.parallel import BatchPOA
    BatchPOA(params).run_consensus(wins)          # compiled and warm
    root = REPO / "build"
    root.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="trace", dir=root))
    # no Python tracer: its events would fill the trace's 1,000,000-event
    # cap, and the device events after it would be dropped
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    try:
        bp = BatchPOA(params)
        with jax.profiler.trace(str(tmp), create_perfetto_trace=True,
                                profiler_options=opts):
            t0 = time.perf_counter()
            bp.run_consensus(wins)
            wall = time.perf_counter() - t0
        path, = tmp.glob("**/perfetto_trace.json.gz")
        with gzip.open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp)
    recs, ivs = device_streams(events)
    compute = union_seconds([iv for name, v in ivs.items()
                             if "Compute" in name for iv in v])
    kernel = sum(r["ops"].get("abpoa_band_dp", 0.0) for r in recs.values())
    launches = sum(r["launches"].get("abpoa_band_dp", 0)
                   for r in recs.values())
    # every device round launches the kernel at least once
    assert launches >= len(bp.dp_intervals), \
        f"the trace lost device events ({launches} kernel launches for " \
        f"{len(bp.dp_intervals)} device rounds)"
    return {"end": bp.engine, "windows": len(wins),
            "traced_wall_seconds": wall, "kernel_seconds": kernel,
            "kernel_launches": launches,
            "device_rounds": len(bp.dp_intervals),
            "compute_busy_seconds": compute,
            "device_idle_share": 1 - compute / wall,
            "host_seconds": bp.host_seconds, "streams": recs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ends", default="kernel,xla")
    ap.add_argument("--seeded", type=int, default=64)
    args = ap.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend is {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from abpoa_tpu.jaxcache import enable_compile_cache
    from abpoa_tpu.params import Params
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = jax.devices()[0]
    rec = {"card": smi, "device": {"platform": dev.platform,
                                   "kind": dev.device_kind,
                                   "count": len(jax.devices())},
           "compile_cache": enable_compile_cache()}
    emit(rec)
    params = Params().post_set()
    wins = make_windows(heter_reads(), args.windows, args.seed)
    ends = args.ends.split(",")
    outs = {}
    for end in ends:
        outs[end], rec[f"e2e_{end}"] = e2e(params, wins, end, args.reps)
        emit({f"e2e_{end}": rec[f"e2e_{end}"]})
    assert all(o == outs[ends[0]] for o in outs.values()), \
        "the DP ends disagree"
    for end in ends:
        rec[f"round_{end}"] = round_time(params, wins, end, args.reps)
        emit({f"round_{end}": rec[f"round_{end}"]})
    if args.seeded:
        rec["seeded"] = seeded(wins[:args.seeded], args.reps)
        emit({"seeded": rec["seeded"]})
    rec["trace"] = trace(params, wins)
    emit({"trace": rec["trace"]})
    emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
