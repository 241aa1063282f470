"""Multi-host data-parallel POA: per-host instance shards + host-0 gather.

The reference is a single process writing to stdout
(ref /root/reference/src/abpoa_align.c:346-362). The replacement here
(SURVEY.md §5 "distributed communication backend") shards INDEPENDENT POA
instances across hosts over DCN — no collectives touch the DP itself — and
gathers the rendered outputs (consensus FASTA / MSA / GFA text) on host 0:

    host p:  BatchPOA over instances[shard_p]  (local chips via Mesh)
    all:     allgather(shard output bytes)     (one DCN collective per run)
    host 0:  concatenate in global instance order

Usage (one process per host, standard JAX multi-process recipe):

    from abpoa_tpu.parallel import multihost as mh
    mh.initialize(coordinator, num_processes, process_id)
    out = mh.run_consensus_fasta(params, instances)  # str on host 0

Validated without a pod: N processes x M virtual CPU devices
(tests/test_multihost.py drives 2 x 4 and byte-compares the gathered
output against a single-process run).
"""
from __future__ import annotations

import io

import numpy as np

from ..params import Params


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """jax.distributed bring-up (idempotent). Pass the coordinator
    address, process count and process id explicitly."""
    import jax
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)


def shard_bounds(n: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous block partition (shard sizes differ by at most 1)."""
    base, rem = divmod(n, num_shards)
    lo = shard * base + min(shard, rem)
    return lo, lo + base + (1 if shard < rem else 0)


def local_shard(instances):
    """This process's contiguous shard of the global instance list."""
    import jax
    lo, hi = shard_bounds(len(instances), jax.process_count(),
                          jax.process_index())
    return instances[lo:hi]


def gather_text(text: str) -> list[str] | None:
    """Allgather one UTF-8 string per process; host 0 gets the list in
    process order, other hosts get None. Two collectives: lengths, then
    max-padded byte buffers."""
    import jax
    from jax.experimental import multihost_utils as mhu
    if jax.process_count() == 1:
        return [text]
    data = np.frombuffer(text.encode(), dtype=np.uint8)
    lens = np.asarray(mhu.process_allgather(
        np.array([data.size], dtype=np.int64))).reshape(-1)
    mx = max(int(lens.max()), 1)
    buf = np.zeros(mx, np.uint8)
    buf[:data.size] = data
    allbuf = np.asarray(mhu.process_allgather(buf))
    if jax.process_index() != 0:
        return None
    return [bytes(allbuf[p][:int(lens[p])]).decode()
            for p in range(len(lens))]


def _local_mesh(batch_axis: str = "data"):
    """Mesh over THIS process's addressable devices (pure data parallelism
    needs no cross-host device mesh — sharding happens at the instance
    list), or None for a single local device."""
    import jax
    from jax.sharding import Mesh
    devs = jax.local_devices()
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), (batch_axis,))


def run_render_gather(params: Params, instances, render, engine=None,
                      use_local_mesh=True, stats=None, seeded=False):
    """Run BatchPOA on this host's shard, render each aligner's output
    with ``render(ab, params, out_io)``, gather across hosts.

    ``seeded=True`` routes the shard through the seeded/windowed pipeline
    (the reference's -S/-p mode, ref src/abpoa_align.c:192-299) — window
    rounds batch across this host's instances and shard over its local
    mesh, exactly like the plain path.

    Returns the concatenated output text (global instance order) on host
    0, None elsewhere. ``stats`` (optional dict) receives this host's
    timing/counter info."""
    import time
    from .batch import BatchPOA
    mine = local_shard(instances)
    mesh = _local_mesh() if use_local_mesh else None
    bp = BatchPOA(params, mesh=mesh, engine=engine)
    t0 = time.perf_counter()
    abs_ = bp.run_seeded(mine) if seeded else bp.run(mine)
    out = io.StringIO()
    for ab in abs_:
        render(ab, params, out)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(shard_instances=len(mine), wall_s=dt,
                     dp_cells=bp.dp_cells, dp_seconds=bp.dp_seconds,
                     fallbacks=bp.fallbacks, rounds=bp.rounds)
    parts = gather_text(out.getvalue())
    return "".join(parts) if parts is not None else None


def _render_output(ab, params, out):
    """The reference's abpoa_output dispatch (consensus/MSA/GFA) per
    aligner (ref src/abpoa_align.c:346-362)."""
    ab.output(params, out)


def run_consensus_fasta(params: Params, instances, engine=None,
                        stats=None, seeded=False):
    """Full distributed pipeline -> consensus FASTA text on host 0."""
    if not (params.out_cons or params.out_msa or params.out_gfa):
        params.out_cons = 1
    return run_render_gather(params, instances, _render_output,
                             engine=engine, stats=stats, seeded=seeded)
