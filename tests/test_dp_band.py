"""The banded GPU kernel (ops/dp_band.py) on the CPU: interpret mode against
the XLA end and the oracle, its Triton module lowered for CUDA and verified,
its mesh wrapping, and one end-to-end batch. Tests marked ``gpu`` run the
compiled kernel on the card and skip here."""
import jax
import numpy as np
import pytest

from test_device_engine import (CASES, IDS, check_against_oracle, encoded,
                                round_case)

from abpoa_tpu.align.engine_jax import (device_round, export_dense,
                                        kernel_inputs, repad_dense)
from abpoa_tpu.ops import layout as L
from abpoa_tpu.ops.dp_band import BandConfig, pick_wb
from abpoa_tpu.params import (Params, GLOBAL_MODE, EXTEND_MODE, LINEAR_GAP,
                              AFFINE_GAP, CONVEX_GAP)

KEYS = [L.M_BEST, L.M_BI, L.M_BJ, L.M_CELLS, L.M_NSTEPS, L.M_FAIL, L.M_ENDI,
        L.M_ENDJ]


def both_ends(dgs, params, **kw):
    mk, sk = jax.device_get(device_round("kernel", dgs, params,
                                         interpret=True, **kw))
    mx, sx = jax.device_get(device_round("xla", dgs, params))
    assert (mk[:, KEYS] == mx[:, KEYS]).all()
    for b in range(len(dgs)):
        n = mk[b, L.M_NSTEPS]
        assert (sk[b, :n] == sx[b, :n]).all()
    return mk, sk


@pytest.mark.parametrize("fn,n,gap,o1,o2,mode,am", CASES, ids=IDS)
def test_kernel_matches_xla_end_and_oracle(fn, n, gap, o1, o2, mode, am):
    params = Params(align_mode=am, gap_open1=o1, gap_open2=o2).post_set()
    graph, q = round_case(fn, n, params)
    dg = export_dense(graph, params, q)
    misc, steps = both_ends([dg], params)
    check_against_oracle(graph, params, q, misc[0], steps[0])


def test_kernel_band_overflow_flag():
    """A band tile too narrow for the row's band raises M_OVFL instead of
    emitting a walk (the host then re-runs the oracle)."""
    from abpoa_tpu.ops.dp_band import band_dp_batch
    params = Params().post_set()
    graph, q = round_case("heter.fa", 3, params)
    cfg, arrs = kernel_inputs([export_dense(graph, params, q)], params)
    narrow = cfg._replace(WB=128)          # 4 segments < band + guard
    misc, _ = jax.device_get(band_dp_batch(narrow, *arrs, interpret=True))
    assert misc[0, L.M_OVFL] == 1 and misc[0, L.M_NSTEPS] == 0


def test_pick_wb_power_of_two():
    params = Params().post_set()
    for qlen, pn in [(14, 32), (52, 32), (769, 32), (769, 16), (5000, 16)]:
        wb = pick_wb(params, qlen, pn)
        assert wb >= 128 and wb & (wb - 1) == 0 and wb % pn == 0


def test_kernel_on_two_device_mesh():
    """The kernel wrapped in shard_map over 2 virtual CPU devices gives the
    unsharded result, with the odd batch padded per device."""
    from jax.sharding import Mesh
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual CPU devices")
    params = Params().post_set()
    cases = [round_case("seq.fa", k, params) for k in (3, 5, 7)]
    dgs = [export_dense(g, params, q) for g, q in cases]
    dims = [max(getattr(d, f) for d in dgs) for f in "RWPO"]
    dgs = [repad_dense(d, *dims) for d in dgs]
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    mm, sm = jax.device_get(device_round("kernel", dgs, params, mesh=mesh,
                                         interpret=True))
    m1, s1 = both_ends(dgs, params)
    assert (mm == m1).all()
    for b in range(3):
        n = m1[b, L.M_NSTEPS]
        assert (sm[b, :n] == s1[b, :n]).all()


def test_batch_kernel_engine_consensus():
    """BatchPOA on the kernel engine (interpret) equals the oracle's
    consensus, with no oracle re-runs."""
    from abpoa_tpu.parallel import BatchPOA
    from test_fallback_bounds import _sequential_consensus
    params = Params().post_set()
    reads = encoded("seq.fa")
    insts = [reads, reads[:6], reads[3:]]
    bp = BatchPOA(params, engine="kernel", interpret=True)
    got = bp.run_consensus(insts)
    assert got == [_sequential_consensus(r, params) for r in insts]
    assert bp.fallbacks == 0 and bp.dp_cells > 0


LOWER = [(CONVEX_GAP, GLOBAL_MODE), (CONVEX_GAP, EXTEND_MODE),
         (AFFINE_GAP, GLOBAL_MODE), (AFFINE_GAP, EXTEND_MODE),
         (LINEAR_GAP, GLOBAL_MODE), (LINEAR_GAP, EXTEND_MODE)]


@pytest.mark.parametrize("gm,am", LOWER,
                         ids=[f"gap{g}-mode{m}" for g, m in LOWER])
def test_triton_module_lowers_and_verifies(gm, am, monkeypatch):
    """Lower the kernel for CUDA on the CPU and run the MLIR verifier over
    its Triton module: catches what the GPU compiler would refuse at parse
    time (operand types, unsupported primitives, non-power-of-two blocks)."""
    from jax._src.pallas.triton import pallas_call_registration as reg
    from abpoa_tpu.ops.dp_band import _band_dp
    lower = reg.lowering.lower_jaxpr_to_triton_module
    seen = []

    def verified(*a, **k):
        res = lower(*a, **k)
        assert res.module.operation.verify()
        seen.append(res)
        return res
    monkeypatch.setattr(reg.lowering, "lower_jaxpr_to_triton_module",
                        verified)
    cfg = BandConfig(gm, am, 32, 1024, 512, 1024, 4, 5, am == EXTEND_MODE,
                     2048)
    S = lambda *s: jax.ShapeDtypeStruct(s, np.int32)  # noqa: E731
    args = (S(8, L.S_NSCAL + 25), S(8, 1024), S(8, 1024, 4), S(8, 1024),
            S(8, 1024), S(8, 1024), S(8, 1024), S(8, 1024))
    low = jax.jit(_band_dp, static_argnums=(0, 1)).trace(
        cfg, False, *args).lower(lowering_platforms=("cuda",))
    assert len(seen) == 1 and "__gpu$xla.gpu.triton" in low.as_text()


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla_end(gpu):
    """The compiled kernel on the card equals the XLA end at heter.fa's
    real width, for twelve mid-run rounds."""
    params = Params().post_set()
    cases = [round_case("heter.fa", k, params) for k in range(3, 15)]
    dgs = [export_dense(g, params, q) for g, q in cases]
    dims = [max(getattr(d, f) for d in dgs) for f in "RWPO"]
    dgs = [repad_dense(d, *dims) for d in dgs]
    mk, sk = jax.device_get(device_round("kernel", dgs, params))
    mx, sx = jax.device_get(device_round("xla", dgs, params))
    assert not mk[:, L.M_OVFL].any()
    assert (mk[:, KEYS] == mx[:, KEYS]).all()
    for b, (g, q) in enumerate(cases):
        assert (sk[b, :mk[b, L.M_NSTEPS]] == sx[b, :mx[b, L.M_NSTEPS]]).all()
        check_against_oracle(g, params, q, mk[b], sk[b])


@pytest.mark.gpu
def test_batch_on_gpu_picks_kernel_and_pipeline(gpu):
    from abpoa_tpu.parallel import BatchPOA
    bp = BatchPOA(Params().post_set())
    assert bp.engine == "kernel" and bp.pipeline and bp.seeded_device
