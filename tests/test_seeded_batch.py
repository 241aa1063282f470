"""Batched seeded POA (run_seeded) equals the sequential anchored path.

On CPU without a mesh this exercises the generator/driver plumbing with
the oracle; the device window rounds (XLA end) run on a GPU or a mesh
(tests/test_seeded_xla.py, chip_smoke.py).
"""
import numpy as np

from conftest import DATA

from abpoa_tpu.api import ABPOA
from abpoa_tpu.consensus import generate_consensus
from abpoa_tpu.alphabet import encode_table, decode_table
from abpoa_tpu.params import Params
from abpoa_tpu.parallel import BatchPOA
from abpoa_tpu.seed import build_guide_tree_partition
from abpoa_tpu.seqio import read_seqs


def _cons(ab, params):
    generate_consensus(ab, params)
    d = decode_table(params.m)
    return [bytes(d[b] for b in s).decode()
            for s in ab.cons.cons_base[:ab.cons.n_cons]]


def test_run_seeded_matches_sequential():
    tab = encode_table(5)
    recs = read_seqs(str(DATA / "heter.fa"))
    reads = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
             for r in recs]
    params = Params(disable_seeding=False).post_set()
    ab0 = ABPOA()
    n = len(reads)
    ab0.n_seq, ab0.names, ab0.is_rc = n, [""] * n, [0] * n
    seq_lens = [len(q) for q in reads]
    rmap, pa_, pc_ = build_guide_tree_partition(reads, seq_lens, params)
    ab0.anchor_poa(params, reads, [[1] * L for L in seq_lens], seq_lens,
                   pa_, pc_, rmap, 0)
    exp = _cons(ab0, Params(disable_seeding=False).post_set())

    bp = BatchPOA(Params(disable_seeding=False).post_set())
    abs_ = bp.run_seeded([reads, reads])
    for a in abs_:
        assert _cons(a, Params(disable_seeding=False).post_set()) == exp
