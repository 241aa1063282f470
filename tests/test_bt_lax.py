"""The standalone lax backtrack (ops/bt_xla.backtrack_one, the walk half
of the XLA end) stays honest: it must reproduce the oracle cigar over
XLA-engine planes (it is the reference twin of the in-kernel walk)."""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from conftest import DATA

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import Params
from abpoa_tpu.seqio import read_seqs
from abpoa_tpu.alphabet import encode_table
from abpoa_tpu import align as aln
from abpoa_tpu.align.engine_jax import export_dense, _make_inputs
from abpoa_tpu.align.engine_np import AlignResult
from abpoa_tpu.ops.dp_xla import banded_poa_dp
from abpoa_tpu.ops import bt_xla


def test_lax_backtrack_matches_oracle():
    tab = encode_table(5)
    recs = read_seqs(str(DATA / "seq.fa"))
    seqs = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in recs][:4]
    params = Params().post_set()
    ab = ABPOA()
    for i, q in enumerate(seqs):
        res_np = aln.align_sequence_to_graph(ab.graph, params, q,
                                             arena=ab.arena)
        if res_np is not None:
            dg = export_dense(ab.graph, params, q)
            cfg, inp = _make_inputs(dg, params)
            out = banded_poa_dp(cfg, inp)
            btc = bt_xla.BTConfig(gap_mode=params.gap_mode, R=dg.R,
                                  WB=dg.W, P=dg.P, LMAX=dg.R + dg.W)
            planes = jnp.stack([out.H, out.E1, out.E2, out.F1, out.F2],
                               axis=1)
            qcodes = np.zeros(dg.W, np.int32)
            qcodes[:dg.qlen] = np.asarray(q)
            walk = jax.jit(partial(bt_xla.backtrack_one, btc))
            steps, n_steps, fail, ei, ej = (np.asarray(x)[None] for x in walk(
                planes, out.dp_beg, out.dp_end,
                jnp.asarray(dg.pre_idx.reshape(-1)), jnp.asarray(dg.pre_n),
                jnp.asarray(dg.bases), jnp.asarray(qcodes),
                jnp.asarray(np.asarray(params.mat, np.int32)), out.best_i,
                out.best_j, jnp.int32(params.gap_ext1),
                jnp.int32(params.gap_oe1), jnp.int32(params.gap_ext2),
                jnp.int32(params.gap_oe2)))
            assert not bool(np.asarray(fail)[0])
            res_d = AlignResult()
            res_d.best_score = int(out.best_score)
            bt_xla.replay_steps(ab.graph, params, np.asarray(q),
                                np.asarray(steps)[0],
                                int(np.asarray(n_steps)[0]),
                                int(out.best_i), int(out.best_j),
                                int(np.asarray(ei)[0]),
                                int(np.asarray(ej)[0]), res_d)
            assert res_d.cigar == res_np.cigar
        cigar = res_np.cigar if res_np is not None else []
        ab.graph.add_graph_alignment(params, q, [1] * len(q), cigar,
                                     None, i, True)
