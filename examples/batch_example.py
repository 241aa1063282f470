#!/usr/bin/env python
"""Batched + sharded usage example — the device throughput surface.

No reference analog: the reference processes one problem at a time on one
core (its list mode is a serial loop, ref /root/reference/src/abpoa.c:
135-143). Here many independent POA problems batch into one device
program per round, and a jax.sharding.Mesh spreads the batch across every
available device (pure data parallelism — instances are independent).

Run from the repo root (any backend; a virtual CPU mesh without a GPU):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        JAX_PLATFORMS=cpu python examples/batch_example.py
"""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        # a preset platform plugin outranks the env var (CLAUDE.md);
        # honor the user's explicit choice
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    from jax.sharding import Mesh
    from abpoa_tpu.params import Params
    from abpoa_tpu.parallel import BatchPOA
    from abpoa_tpu.seqio import read_seqs
    from abpoa_tpu.alphabet import encode_table

    repo = pathlib.Path(__file__).resolve().parent.parent
    tab = encode_table(5)
    recs = read_seqs(str(repo / "tests" / "data" / "seq.fa"))
    reads = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
             for r in recs]

    # a "problem" is one read set; real workloads batch thousands of
    # amplicon/UMI windows — every instance is independent
    instances = [reads, reads[:8], reads[:6]] * 4

    # single device (or single-chip batching)
    bp = BatchPOA(Params().post_set())
    cons = bp.run_consensus(instances)
    print(f"batched: {len(cons)} consensus sequences, "
          f"{bp.dp_cells} DP cells on device, {bp.rounds} rounds")

    # sharded over every visible device
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("data",))
    bpm = BatchPOA(Params().post_set(), mesh=mesh)
    cons_m = bpm.run_consensus(instances)
    assert cons_m == cons
    print(f"mesh({len(devs)} devices): identical consensus "
          f"({len(cons_m)} instances sharded data-parallel)")

    # the seeded/windowed (-S) pipeline shards the same way
    p = Params().post_set()
    p.disable_seeding = 0
    p.post_set()
    cons_s = BatchPOA(p, mesh=mesh).run_consensus(instances, seeded=True)
    print(f"seeded over mesh: {len(cons_s)} consensus sequences")


if __name__ == "__main__":
    main()
