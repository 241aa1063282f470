"""JAX engine vs host oracle: per-call score/cigar equality on fixtures.

Gate M3 from SURVEY.md §7: the device (JAX/XLA) DP must produce identical
cigars and scores to the bit-exact host oracle on every alignment of the
golden fixtures, across align modes x gap modes.
"""
import numpy as np
import pytest

from conftest import DATA

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import (Params, GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE,
                              LINEAR_GAP, AFFINE_GAP, CONVEX_GAP)
from abpoa_tpu.seqio import read_seqs
from abpoa_tpu.alphabet import encode_table
from abpoa_tpu import align as aln
from abpoa_tpu.align.engine_jax import align_sequence_to_graph_jax


def _encoded(fn, limit=None):
    tab = encode_table(5)
    recs = read_seqs(str(DATA / fn))
    seqs = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)] for r in recs]
    return seqs[:limit] if limit else seqs


def _run_both(seqs, params):
    """Drive plain POA with the oracle; at every align call also run the JAX
    engine on the same graph state and compare."""
    ab = ABPOA()
    n_checked = 0
    for i, q in enumerate(seqs):
        res_np = aln.align_sequence_to_graph(ab.graph, params, q,
                                             arena=ab.arena)
        if res_np is not None:
            res_jx = align_sequence_to_graph_jax(ab.graph, params, q)
            assert res_jx.best_score == res_np.best_score, \
                f"read {i}: score {res_jx.best_score} != {res_np.best_score}"
            assert res_jx.cigar == res_np.cigar, f"read {i}: cigar mismatch"
            n_checked += 1
        cigar = res_np.cigar if res_np is not None else []
        ab.graph.add_graph_alignment(params, q, [1] * len(q), cigar, None,
                                     i, True)
    assert n_checked > 0


MODES = [
    ("global-convex", GLOBAL_MODE, 4, 24),
    ("global-affine", GLOBAL_MODE, 4, 0),
    ("global-linear", GLOBAL_MODE, 0, 0),
    ("local-convex", LOCAL_MODE, 4, 24),
    ("local-affine", LOCAL_MODE, 4, 0),
    ("local-linear", LOCAL_MODE, 0, 0),
    ("extend-convex", EXTEND_MODE, 4, 24),
]


@pytest.mark.parametrize("name,amode,o1,o2", MODES, ids=[m[0] for m in MODES])
def test_seq_fa_modes(name, amode, o1, o2):
    params = Params(align_mode=amode, gap_open1=o1, gap_open2=o2).post_set()
    _run_both(_encoded("seq.fa"), params)


def test_seq_fa_unbanded():
    params = Params(wb=-1).post_set()
    _run_both(_encoded("seq.fa"), params)


def test_heter_fa_convex():
    params = Params().post_set()
    _run_both(_encoded("heter.fa", limit=6), params)


def test_test_fa_zdrop_extend():
    params = Params(align_mode=EXTEND_MODE, zdrop=100).post_set()
    _run_both(_encoded("test.fa"), params)


# --- end-to-end: CLI byte parity vs the reference goldens, JAX engine ---

from conftest import GOLDEN_SAN  # noqa: E402

E2E_CASES = [
    ("seq_cons.fa", []),
    ("seq_cons_msa.out", ["-r2"]),
    ("seq.gfa", ["-r3"]),
    ("seq_cons_local.fa", ["-m", "1"]),
    ("heter_d2_cons.fa", ["-d2"]),
]


@pytest.mark.parametrize("golden,extra", E2E_CASES,
                         ids=[c[0] for c in E2E_CASES])
def test_cli_golden_jax_engine(golden, extra):
    from test_parity import run_cli
    fn = str(DATA / ("heter.fa" if golden.startswith("heter") else "seq.fa"))
    expected = (GOLDEN_SAN / golden).read_text()
    assert run_cli(["--engine", "jax", *extra, fn]) == expected


# --- the INT16 dispatch bound (round-3 verdict item 7) -------------------
# dp_xla's closed-form F recurrence documents a theoretical divergence
# "at the 16-bit dispatch bound where real scores approach INT16_MIN"
# (ops/dp_xla.py). These cases sit an alignment exactly at the bound
# (qlen*match ~= 32767 - min_mis - gap_oe, ref simd_abpoa_align.c
# :1667-1683 via engine_np.score_width_dispatch) on BOTH sides, with
# real scores driven near INT16_MAX / below inf_min, and assert
# oracle == dp_xla (== the banded kernel, interpret mode, on the 16-bit
# side) scores and cigars.

def _bound_graph(params, g_read):
    ab = ABPOA()
    ab.graph.add_graph_alignment(params, g_read, [1] * len(g_read), [],
                                 None, 0, True)
    return ab


@pytest.mark.parametrize("match,want_bits", [(1022, 16), (1023, 32)],
                         ids=["at-bound-16", "past-bound-32"])
def test_int16_dispatch_bound_high(match, want_bits):
    """qlen*match sits exactly at / one past the 16-bit bound; perfect
    match drives the real best score to ~INT16_MAX on the 16-bit side."""
    from abpoa_tpu.align.engine_np import score_width_dispatch
    params = Params(match=match).post_set()
    # bound = 32767 - min_mis(9) - oe1(6) - oe2(25) = 32727; qlen=32:
    # 32*1022 = 32704 <= 32727 (16-bit), 32*1023 = 32736 > (32-bit)
    rng = np.random.default_rng(3)
    g_read = rng.integers(0, 4, 32).astype(np.uint8)
    ab = _bound_graph(params, g_read)
    q = g_read.copy()
    bits, pn, _ln, _inf = score_width_dispatch(params, ab.graph.node_n,
                                               len(q))
    assert bits == want_bits
    res_np = aln.align_sequence_to_graph(ab.graph, params, q,
                                         arena=ab.arena)
    res_jx = align_sequence_to_graph_jax(ab.graph, params, q)
    assert res_np.best_score == 32 * match
    assert res_jx.best_score == res_np.best_score
    assert res_jx.cigar == res_np.cigar
    if want_bits == 16:
        # banded kernel (interpret) on the same export, 16-bit geometry
        import jax
        from abpoa_tpu.align.engine_jax import export_dense, device_round
        from abpoa_tpu.ops import layout as L
        ab2 = _bound_graph(params, g_read)
        ab2.graph.topological_sort(params)
        dg = export_dense(ab2.graph, params, q)
        assert dg.pn == 32  # 16-bit mode doubles the lane count
        misc, _ = jax.device_get(device_round("kernel", [dg], params,
                                              interpret=True))
        assert not misc[0, L.M_OVFL] and not misc[0, L.M_FAIL]
        assert int(misc[0, L.M_BEST]) == res_np.best_score


def test_int16_dispatch_bound_deep_negative():
    """16-bit dispatch with an all-negative score matrix and symmetric
    expensive gaps: the optimal global score (~-30000) sits far below
    inf_min (~-17800), the regime where the reference's int16 F-scan
    intermediates would wrap (documented dp_xla caveat)."""
    from abpoa_tpu.align.engine_np import score_width_dispatch
    params = Params(gap_open1=450, gap_ext1=450, gap_open2=0).post_set()
    params.mat = np.full((5, 5), -1000, dtype=np.int64)
    params.max_mat = -1000
    params.min_mis = 1000
    rng = np.random.default_rng(11)
    g_read = rng.integers(0, 4, 32).astype(np.uint8)
    q = (g_read[:33 - 32].tolist() and None) or rng.integers(
        0, 4, 33).astype(np.uint8)
    ab = _bound_graph(params, g_read)
    bits, _pn, _ln, inf_min = score_width_dispatch(params,
                                                   ab.graph.node_n,
                                                   len(q))
    assert bits == 16
    res_np = aln.align_sequence_to_graph(ab.graph, params, q,
                                         arena=ab.arena)
    res_jx = align_sequence_to_graph_jax(ab.graph, params, q)
    # the banded optimum clamps AT the inf_min floor: every in-band path
    # costs more than |inf_min|, i.e. real cell values hit the int16
    # saturation floor — exactly the caveat regime
    assert res_np.best_score <= inf_min
    assert res_jx.best_score == res_np.best_score
    assert res_jx.cigar == res_np.cigar
