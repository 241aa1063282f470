"""pyabpoa-compatible API: results match the reference goldens.

The reference bindings loop plain align/add per sequence (no seeding, no
progressive POA; ref python/pyabpoa.pyx:133-134,179-189) — i.e. the default
CLI configuration — so cons_seq/msa_seq must equal the golden outputs.
"""
from conftest import DATA, GOLDEN_SAN

import abpoa_tpu.pyabpoa as pa
from abpoa_tpu.seqio import read_seqs


def _seqs(fn):
    return [r.seq for r in read_seqs(str(DATA / fn))]


def _golden_records(fn):
    txt = (GOLDEN_SAN / fn).read_text().strip().split("\n")
    names, seqs = [], []
    for line in txt:
        if line.startswith(">"):
            names.append(line[1:])
            seqs.append("")
        else:
            seqs[-1] += line
    return names, seqs


def test_cons_matches_golden():
    a = pa.msa_aligner()
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=False)
    _, golden = _golden_records("seq_cons.fa")
    assert res.n_cons == 1
    assert res.cons_seq == golden
    assert res.cons_len == [len(golden[0])]
    assert len(res.cons_cov[0]) == len(golden[0])


def test_msa_matches_golden():
    a = pa.msa_aligner()
    res = a.msa(_seqs("seq.fa"), out_cons=True, out_msa=True)
    _, golden = _golden_records("seq_cons_msa.out")
    assert res.msa_seq == golden
    assert res.msa_len == len(golden[0])
    assert res.n_seq == 10


def test_multi_consensus():
    a = pa.msa_aligner()
    res = a.msa(_seqs("heter.fa"), out_cons=True, out_msa=False,
                max_n_cons=2)
    _, golden = _golden_records("heter_d2_cons.fa")
    assert res.n_cons == 2
    assert res.cons_seq == golden
    assert sum(res.clu_n_seq) == 15
    assert sorted(res.clu_read_ids[0] + res.clu_read_ids[1]) \
        == list(range(15))


def test_local_mode_and_reuse():
    a = pa.msa_aligner(aln_mode='l')
    res1 = a.msa(_seqs("test.fa"), out_cons=True, out_msa=False)
    assert res1.n_cons == 1 and res1.cons_seq[0]
    # aligner is reusable (reference resets per msa call)
    res2 = a.msa(_seqs("test.fa"), out_cons=True, out_msa=False)
    assert res2.cons_seq == res1.cons_seq


def test_incremental(tmp_path):
    a = pa.msa_aligner()
    res = a.msa(_seqs("seq.fa"), out_cons=False, out_msa=True,
                incr_fn=str(GOLDEN_SAN / "seq_msa.out"))
    _, golden = _golden_records("seq_incr_msa.out")  # -r1: no consensus row
    assert res.msa_seq == golden
    assert res.n_seq == 20


def test_msa_batch_matches_single():
    """The batched msa_batch extension must return, per input, the
    same msa_result fields as a fresh .msa() call on that input."""
    import abpoa_tpu.pyabpoa as pa
    seqs = ["ACGTACGTACGT", "ACGTACGAACGT", "ACGTACGTACG",
            "AGGTACGTACGT"]
    inputs = [seqs, seqs[::-1], [s[:-2] for s in seqs], seqs]
    a = pa.msa_aligner()
    batch = a.msa_batch(inputs, out_cons=True, out_msa=True)
    for inp, br in zip(inputs, batch):
        sr = pa.msa_aligner().msa(inp, out_cons=True, out_msa=True)
        assert br.n_cons == sr.n_cons
        assert br.cons_seq == sr.cons_seq
        assert br.msa_seq == sr.msa_seq
        assert br.cons_cov == sr.cons_cov
