"""The device DP ends against the host oracle, and the choices around them.

The XLA end (ops/dp_xla sweep + ops/bt_xla walk in one jit) is the plain
reference and the CPU engine; the banded kernel (ops/dp_band.py) must give
the same misc rows and step streams (tests/test_dp_band.py). Here: the XLA
end's parity with the bit-exact oracle over fixtures x gap modes x
global/extend, batch padding and mixed query lengths in one bucket, the
memory cap that splits a round into calls, single-file subgraph windows on
the device, the engine choice from the platform, and the compile-cache
helper.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from conftest import DATA, REPO

from abpoa_tpu.api import ABPOA
from abpoa_tpu.alphabet import encode_table
from abpoa_tpu.align.engine_jax import (device_round, export_dense,
                                        pick_engine, repad_dense,
                                        replay_result, round_kind)
from abpoa_tpu.align.engine_np import align_sequence_to_subgraph
from abpoa_tpu.ops import layout as L
from abpoa_tpu.params import (Params, GLOBAL_MODE, EXTEND_MODE, CONVEX_GAP,
                              SRC_NODE_ID, SINK_NODE_ID)
from abpoa_tpu.seqio import read_seqs

FIXTURES = [("seq.fa", 10), ("test.fa", 4), ("heter.fa", 5)]
GAPS = [("linear", 0, 0), ("affine", 4, 0), ("convex", 4, 24)]
MODES = [("global", GLOBAL_MODE), ("extend", EXTEND_MODE)]
CASES = [(f, n, g, o1, o2, m, am) for f, n in FIXTURES
         for g, o1, o2 in GAPS for m, am in MODES]
IDS = [f"{c[0]}-{c[2]}-{c[5]}" for c in CASES]


def encoded(fn, limit=None):
    tab = encode_table(5)
    seqs = [tab[np.frombuffer(r.seq.encode(), dtype=np.uint8)]
            for r in read_seqs(str(DATA / fn))]
    return seqs[:limit] if limit else seqs


def round_case(fn, n, params):
    """A mid-run round: the oracle's graph of the first n-1 reads, sorted,
    and the n-th read as the query."""
    reads = encoded(fn, n)
    ab = ABPOA()
    ab.n_seq, ab.names, ab.is_rc = n, [""] * n, [0] * n
    ab.poa(params, reads[:-1], [[1] * len(q) for q in reads[:-1]], 0)
    ab.graph.topological_sort(params)
    return ab.graph, reads[-1]


def check_against_oracle(graph, params, query, misc, steps):
    assert not misc[L.M_OVFL] and not misc[L.M_FAIL]
    got = replay_result(graph, params, query, misc, steps)
    ref = align_sequence_to_subgraph(graph, params, SRC_NODE_ID,
                                     SINK_NODE_ID, query)
    assert got.best_score == ref.best_score
    assert got.cigar == ref.cigar
    assert (got.node_s, got.node_e, got.query_s, got.query_e) == \
        (ref.node_s, ref.node_e, ref.query_s, ref.query_e)


@pytest.mark.parametrize("fn,n,gap,o1,o2,mode,am", CASES, ids=IDS)
def test_xla_end_matches_oracle(fn, n, gap, o1, o2, mode, am):
    params = Params(align_mode=am, gap_open1=o1, gap_open2=o2).post_set()
    graph, q = round_case(fn, n, params)
    dg = export_dense(graph, params, q)
    misc, steps = jax.device_get(device_round("xla", [dg], params))
    check_against_oracle(graph, params, q, misc[0], steps[0])


def test_padding_and_mixed_lengths_in_one_bucket():
    """Three instances with different query lengths share one padded
    bucket (B pads to 4 with a live instance): each row equals its own
    single-instance round and the oracle."""
    params = Params().post_set()
    cases = [round_case("heter.fa", 4, params), round_case("seq.fa", 6,
                                                           params)]
    g3, q3 = round_case("heter.fa", 3, params)
    cases.append((g3, q3[:400]))
    dgs = [export_dense(g, params, q) for g, q in cases]
    dims = [max(getattr(d, f) for d in dgs) for f in "RWPO"]
    dgs = [repad_dense(d, *dims) for d in dgs]
    misc, steps = jax.device_get(device_round("xla", dgs, params))
    assert misc.shape[0] == 3
    for b, (g, q) in enumerate(cases):
        check_against_oracle(g, params, q, misc[b], steps[b])
        m1, s1 = jax.device_get(device_round("xla", [dgs[b]], params))
        assert (m1[0] == misc[b]).all()
        assert (s1[0, :m1[0, L.M_NSTEPS]]
                == steps[b, :misc[b, L.M_NSTEPS]]).all()


def test_call_batch_caps_device_memory():
    """A round of long windows splits into calls that each fit the
    per-device budget; a small group pads to a power of two per device."""
    from abpoa_tpu.align import engine_jax as E
    from abpoa_tpu.ops.dp_band import BandConfig, instance_bytes
    cfg = BandConfig(CONVEX_GAP, GLOBAL_MODE, 32, 4096, 512, 4096, 4, 5,
                     False, 8192)
    per = instance_bytes(cfg)
    assert per >= 4 * 4 * 4096 * 512      # H, E1, E2 and bits planes
    for ndev in (1, 4):
        bp = E.call_batch(4096, per, ndev)
        each = bp // ndev
        assert bp % ndev == 0 and each & (each - 1) == 0
        assert each * per <= E._CALL_BYTES and bp < 4096
    assert E.call_batch(5, per, 1) == 8
    assert E.call_batch(5, per, 4) == 8
    assert E.call_batch(3, 1 << 40, 1) == 1  # past the budget: one by one


@pytest.mark.parametrize("kind", ["xla", "planes"])
def test_round_splits_into_calls(kind, monkeypatch):
    """With a budget of two instances per call, a five-instance round runs
    as three calls and gives the one-call result."""
    from abpoa_tpu.align import engine_jax as E
    params = Params().post_set()
    cases = [round_case("seq.fa", k, params) for k in (3, 4, 5, 6, 7)]
    dgs = [export_dense(g, params, q) for g, q in cases]
    dims = [max(getattr(d, f) for d in dgs) for f in "RWPO"]
    dgs = [repad_dense(d, *dims) for d in dgs]
    whole = jax.device_get(device_round(kind, dgs, params))
    calls = []
    wrap = E._mesh_wrap

    def counted(fn, *a):
        inner = wrap(fn, *a)

        def call(*arrs):
            calls.append(jax.tree.leaves(arrs)[0].shape[0])
            return inner(*arrs)
        return call
    monkeypatch.setattr(E, "_mesh_wrap", counted)
    monkeypatch.setattr(E, "_CALL_BYTES", 2 * 40 * dims[0] * dims[1])
    split = jax.device_get(device_round(kind, dgs, params))
    assert calls == [2, 2, 2]
    for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(split)):
        assert a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("extra,golden", [(["-S"], "heter_S_cons.fa"),
                                          (["-S", "-p"], "heter_Sp_cons.fa")],
                         ids=["S", "Sp"])
def test_single_file_seeded_windows_on_device(extra, golden, monkeypatch):
    """Single-file ``--engine jax -S``: subgraph windows run B = 1 XLA
    planes rounds, and the output equals abPOA's."""
    from abpoa_tpu.align import engine_jax as E
    from conftest import GOLDEN_SAN
    from test_parity import run_cli
    windows = []
    orig = E.device_round

    def spy(kind, dgs, *a, **k):
        windows.append(kind == "planes" and dgs[0].rowmask is not None)
        return orig(kind, dgs, *a, **k)
    monkeypatch.setattr(E, "device_round", spy)
    got = run_cli(["--engine", "jax", *extra, str(DATA / "heter.fa")])
    assert got == (GOLDEN_SAN / golden).read_text()
    assert any(windows)


def test_round_kind_from_input():
    params = Params().post_set()
    g, q = round_case("seq.fa", 3, params)
    dg = export_dense(g, params, q)
    assert round_kind("kernel", [dg], params) == "kernel"
    assert round_kind("xla", [dg], params) == "xla"
    local = Params(align_mode=1).post_set()
    assert round_kind("kernel", [dg], local) == "planes"
    unbanded = Params(wb=-1).post_set()
    assert round_kind("kernel", [dg], unbanded) == "xla"


def test_engine_choice_cpu():
    assert jax.default_backend() == "cpu"
    assert pick_engine() == "xla"
    assert pick_engine("xla") == "xla"
    assert pick_engine("kernel", interpret=True) == "kernel"
    with pytest.raises(RuntimeError, match="GPU"):
        pick_engine("kernel")
    with pytest.raises(ValueError):
        pick_engine("pallas")


def test_engine_choice_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pick_engine() == "kernel"
    assert pick_engine("auto") == "kernel"
    assert pick_engine("xla") == "xla"


def test_kernel_request_off_gpu_raises():
    from abpoa_tpu.parallel import BatchPOA
    from abpoa_tpu.ops.dp_band import band_dp_batch
    params = Params().post_set()
    with pytest.raises(RuntimeError, match="GPU"):
        BatchPOA(params, engine="kernel")
    with pytest.raises(RuntimeError, match="GPU"):
        band_dp_batch(None, *([None] * 8))
    bp = BatchPOA(params)
    assert bp.engine == "xla" and not bp.pipeline and not bp.seeded_device


def _cache_probe(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    code = ("import jax, jax.numpy as jnp\n"
            "from abpoa_tpu.jaxcache import enable_compile_cache\n"
            "d = enable_compile_cache()\n"
            "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
            "print(d)\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(env, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and the
    compiled entry lands in that directory."""
    d = tmp_path / "cache"
    used, config = _cache_probe(tmp_path, d)
    assert used == config == str(d)
    assert any(d.iterdir())


def test_compile_cache_default_dir(tmp_path):
    """Without it, the cache is <checkout>/.jax_cache."""
    used, config = _cache_probe(tmp_path, None)
    assert used == config == str(pathlib.Path(REPO) / ".jax_cache")
