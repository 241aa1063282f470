"""Packed-backtrack capacity guards: R > 4096 rows must route around the
device walk (step encoding op|row<<2|col<<14 holds 12 row bits) and still
produce oracle-identical results."""
import numpy as np

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import Params
from abpoa_tpu.consensus import generate_consensus
from abpoa_tpu.alphabet import decode_table
from abpoa_tpu.parallel import BatchPOA


def _long_reads(n=3, L=4200, seed=7):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, size=L).astype(np.uint8)
    reads = [base.copy()]
    for i in range(1, n):
        q = base.copy()
        pos = rng.choice(L, size=25, replace=False)
        q[pos] = (q[pos] + 1 + rng.randint(0, 3, size=25)) % 4
        reads.append(q.astype(np.uint8))
    return reads


def _sequential_consensus(reads, params):
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    ab.poa(params, reads, [[1] * len(q) for q in reads], 0)
    generate_consensus(ab, params)
    tab = decode_table(params.m)
    return [bytes(tab[b] for b in s).decode()
            for s in ab.cons.cons_base[:ab.cons.n_cons]]


def test_plain_guard_r_gt_4096(monkeypatch):
    """The >4096-row graph takes the XLA planes round inside the kernel
    engine's dispatch (no packed steps) and matches the oracle."""
    reads = _long_reads()
    expected = _sequential_consensus(reads, Params().post_set())

    # the kernel engine (interpret mode on CPU), so the capacity guard is
    # what routes to the XLA planes round
    bp = BatchPOA(Params().post_set(), engine="kernel", interpret=True)
    calls = {"xla": 0}
    orig = bp._planes_round

    def spy(dgs):
        calls["xla"] += 1
        return orig(dgs)

    monkeypatch.setattr(bp, "_planes_round", spy)
    got = bp.run_consensus([reads])
    assert got == [expected]
    # graph grows past 4096 rows by read 2: the guard must have engaged
    assert calls["xla"] >= 1


def test_seeded_guard_r_gt_4096(monkeypatch):
    """run_seeded routes windows past the device capacity to the host
    oracle, counts them, and matches the sequential seeded result."""
    params = Params().post_set()
    params.disable_seeding = 0
    # independent random reads: no shared minimizers -> no anchors -> the
    # windows are whole-graph (>4096 rows), all hitting the guard
    rng = np.random.RandomState(3)
    reads = [rng.randint(0, 4, size=4200).astype(np.uint8)
             for _ in range(3)]

    seq_params = Params().post_set()
    seq_params.disable_seeding = 0
    from abpoa_tpu.seed import build_guide_tree_partition
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    lens = [len(q) for q in reads]
    rmap, par_anchors, par_c = build_guide_tree_partition(reads, lens,
                                                          seq_params)
    ab.anchor_poa(seq_params, reads, [[1] * L for L in lens], lens,
                  par_anchors, par_c, rmap, 0)
    generate_consensus(ab, seq_params)
    tab = decode_table(seq_params.m)
    expected = [bytes(tab[b] for b in s).decode()
                for s in ab.cons.cons_base[:ab.cons.n_cons]]

    bp = BatchPOA(params)
    bp.seeded_device = True   # the device path, as on a GPU
    abs_ = bp.run_seeded([reads])
    assert bp.fallbacks >= 1
    generate_consensus(abs_[0], params)
    got = [bytes(tab[b] for b in s).decode()
           for s in abs_[0].cons.cons_base[:abs_[0].cons.n_cons]]
    assert got == expected
