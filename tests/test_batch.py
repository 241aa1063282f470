"""Batched device POA == single-instance oracle pipeline, incl. mesh DP."""
import numpy as np
import pytest

from conftest import DATA

from abpoa_tpu.api import ABPOA
from abpoa_tpu.params import Params
from abpoa_tpu.seqio import read_seqs
from abpoa_tpu.alphabet import encode_table, decode_table
from abpoa_tpu.consensus import generate_consensus
from abpoa_tpu.parallel import BatchPOA


def _encoded(fn):
    tab = encode_table(5)
    recs = read_seqs(str(DATA / fn))
    return [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in recs]


def _oracle_consensus(reads, params):
    ab = ABPOA()
    ab.n_seq = len(reads)
    ab.names = [""] * len(reads)
    ab.is_rc = [0] * len(reads)
    ab.poa(params, reads, [[1] * len(q) for q in reads], 0)
    generate_consensus(ab, params)
    tab = decode_table(params.m)
    return [bytes(tab[b] for b in seq).decode()
            for seq in ab.cons.cons_base[:ab.cons.n_cons]]


def test_batch_matches_oracle():
    params = Params().post_set()
    insts = [_encoded("seq.fa"), _encoded("test.fa"), _encoded("seq.fa")[:5]]
    expected = [_oracle_consensus(r, Params().post_set()) for r in insts]
    bp = BatchPOA(Params().post_set())
    got = bp.run_consensus(insts)
    assert got == expected
    assert bp.dp_cells > 0 and bp.rounds > 0


def test_batch_mesh_sharded():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (virtual CPU mesh)")
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("data",))
    params = Params().post_set()
    insts = [_encoded("seq.fa") for _ in range(4)]
    expected = _oracle_consensus(_encoded("seq.fa"), Params().post_set())
    got = BatchPOA(params, mesh=mesh).run_consensus(insts)
    assert all(g == expected for g in got)


def test_batch_amb_strand_matches_sequential():
    """-s in the batched driver: flagged reads take the sequential fwd+rc
    retry (ref abpoa_align.c:315) and must match ABPOA.poa exactly,
    including is_rc flags."""
    from abpoa_tpu.alphabet import revcomp_codes
    params = Params().post_set()
    params.amb_strand = 1
    reads = _encoded("seq.fa")
    # reverse-complement alternating reads -> rc retries must trigger
    mixed = [revcomp_codes(q) if i % 2 else q
             for i, q in enumerate(reads)]
    seq_params = Params().post_set()
    seq_params.amb_strand = 1
    ab = ABPOA()
    ab.n_seq = len(mixed)
    ab.names = [""] * len(mixed)
    ab.is_rc = [0] * len(mixed)
    ab.poa(seq_params, mixed, [[1] * len(q) for q in mixed], 0)
    generate_consensus(ab, seq_params)
    tab = decode_table(seq_params.m)
    expected = [bytes(tab[b] for b in s).decode()
                for s in ab.cons.cons_base[:ab.cons.n_cons]]

    bp = BatchPOA(params)
    abs_ = bp.run([mixed] * 3)
    got = BatchPOA(params).run_consensus([mixed] * 3)
    assert got == [expected] * 3
    assert all(a.is_rc == ab.is_rc for a in abs_)
    assert any(ab.is_rc), "fixture should trigger rc retries"


def test_cli_list_mode_batched_matches_serial(tmp_path):
    """CLI -l with --engine jax batches one instance per file; output must
    byte-match the serial per-file path (the reference's list loop,
    ref abpoa.c -l handling + abpoa_align.c:439-503)."""
    import io
    import contextlib
    from abpoa_tpu import cli
    from conftest import DATA
    lst = tmp_path / "files.txt"
    lst.write_text("\n".join([str(DATA / "seq.fa")] * 4) + "\n")

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        return buf.getvalue()

    serial = run(["-r2", "-l", str(lst)])
    batched = run(["--engine", "jax", "-r2", "-l", str(lst)])
    assert batched == serial


def test_device_call_buckets_batch_dim():
    """Live-group sizes shrink as instances finish; the device round must
    pad the batch dim to a bounded bucket set so each distinct B is not a
    fresh XLA trace of the DP + walk (round-3 review finding)."""
    from abpoa_tpu.ops import bt_xla
    from abpoa_tpu.parallel.batch import BatchPOA
    from abpoa_tpu.params import Params
    reads = _encoded("seq.fa")
    p = Params().post_set()
    base = bt_xla.dp_bt_batch._cache_size()
    # instance counts 5 and 7 both bucket to B=8: one trace, not two
    BatchPOA(p, engine="xla").run([reads] * 5)
    n5 = bt_xla.dp_bt_batch._cache_size()
    BatchPOA(p, engine="xla").run([reads] * 7)
    n7 = bt_xla.dp_bt_batch._cache_size()
    assert n5 > base, "expected at least one fresh trace"
    assert n7 == n5, "B=7 must reuse the B=5 bucket's traces"
