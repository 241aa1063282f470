"""Seeded/windowed batching on the XLA engine, sharded over a mesh.

The config-5 north-star workload (-S seeded windows, BASELINE.json) must
run data-parallel over a device mesh. On CPU the effective engine is XLA:
run_seeded routes window rounds through _seeded_dispatch_xla — subgraph
exports through dp_xla.banded_poa_dp_batch, sharded over the mesh by
align/engine_jax.device_round. Output must be
byte-identical to the serial oracle pipeline (ref abpoa_anchor_poa
src/abpoa_align.c:192-299).
"""
import numpy as np
import pytest

from conftest import DATA

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import Params
from abpoa_tpu.seqio import read_seqs
from abpoa_tpu.alphabet import encode_table, decode_table
from abpoa_tpu.consensus import generate_consensus
from abpoa_tpu.parallel import BatchPOA


def _reads(fn):
    tab = encode_table(5)
    recs = read_seqs(str(DATA / fn))
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in recs]


def _params():
    p = Params().post_set()
    p.disable_seeding = 0
    p.post_set()
    return p


def _cons_strings(ab, params):
    generate_consensus(ab, params)
    tab = decode_table(params.m)
    c = ab.cons
    return [bytes(tab[b] for b in seq).decode()
            for seq in c.cons_base[:c.n_cons]]


def _serial_seeded(reads):
    from abpoa_tpu.seed import build_guide_tree_partition
    params = _params()
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    seq_lens = [len(q) for q in reads]
    rmap, anc, parc = build_guide_tree_partition(reads, seq_lens, params)
    ab.anchor_poa(params, reads, [[1] * L for L in seq_lens], seq_lens,
                  anc, parc, rmap, 0)
    return _cons_strings(ab, params)


def test_seeded_mesh_xla_heterogeneous_parity():
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs multi-device (virtual CPU mesh)")
    from jax.sharding import Mesh
    reads = _reads("heter.fa")
    # heterogeneous instances (different read subsets -> different
    # windows and rounds per shard) catch order/gather bugs that
    # identical copies cancel out
    variants = [reads, reads[:12]]
    insts = [variants[k % 2] for k in range(4)]
    expected = [_serial_seeded(v) for v in variants]

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    bp = BatchPOA(_params(), mesh=mesh)
    abs_ = bp.run_seeded(insts)
    got = [_cons_strings(ab, _params()) for ab in abs_]
    assert got == [expected[k % 2] for k in range(4)]
    # the device path actually ran (not the host oracle)
    assert bp.dp_cells > 0 and bp.rounds > 0
