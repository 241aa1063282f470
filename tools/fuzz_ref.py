#!/usr/bin/env python
"""Differential fuzzer: byte-compare the CLI against the sanitized
reference binary on randomized inputs x randomized flag combinations.

Each seed deterministically generates one case: a read set (mutated
copies of a random ancestor — or of two haplotypes when multi-consensus
is drawn) plus a flag vector sampled over the full CLI surface
(modes x gap models x banding x outputs x seeding x qv x aa).
Both sides run on the same input file; stdout must match byte for byte.

Reference side: `.refbuild/bin/abpoa` (the sanitized build, see
docs/REFERENCE_UB.md) with CANARY_BYTE=0x00 — the reference's defined
semantics. Build it with tests/golden/make_sanitized_ref.sh.

Campaign:  python tools/fuzz_ref.py --n 500 [--start 0] [--keep-going]
Failures save a self-contained repro under $TMPDIR/abpoa_fuzz/<seed>/.

The pytest suite runs a fixed-seed subset (tests/test_fuzz_ref.py).
"""
from __future__ import annotations

import argparse
import io
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import contextlib

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
REF_BIN = REPO / ".refbuild" / "bin" / "abpoa"

NT = "ACGT"
AA = "ARNDCQEGHILKMFPSTWYVBZX"  # 23 of the 26-letter aa alphabet
RC = str.maketrans("ACGTacgt", "TGCAtgca")


# ------------------------------------------------------------------ #
def _mutate(rng, seq: str, alpha: str, sub_p: float, ind_p: float) -> str:
    out = []
    i = 0
    n = len(seq)
    while i < n:
        r = rng.random()
        if r < ind_p / 2:                      # deletion
            i += 1
            continue
        if r < ind_p:                          # insertion
            out.append(alpha[rng.integers(len(alpha))])
            continue                           # retry same position
        c = seq[i]
        if rng.random() < sub_p:
            c = alpha[rng.integers(len(alpha))]
        out.append(c)
        i += 1
    return "".join(out) or alpha[0]


def gen_case(seed: int):
    """-> (fasta_text, is_fastq, args:list[str], descr:str)"""
    rng = np.random.default_rng(seed)
    is_aa = rng.random() < 0.15
    alpha = AA if is_aa else NT
    if (not is_aa) and rng.random() < 0.12:
        # long reads: stresses adaptive banding, the reference-default
        # seeding window partition (min_w 500), and the 16/32-bit
        # score-width boundary
        L = int(rng.integers(600, 3000))
        n_reads = int(rng.integers(2, 7))
    else:
        L = int(rng.integers(15, 401))
        n_reads = int(rng.integers(1, 13))
    sub_p = float(rng.choice([0.0, 0.02, 0.05, 0.1, 0.2]))
    ind_p = float(rng.choice([0.0, 0.01, 0.03, 0.08]))
    anc = "".join(alpha[k] for k in rng.integers(0, len(alpha), L))

    args: list[str] = []
    descr = ["aa" if is_aa else "nt", f"L={L}", f"n={n_reads}"]
    if is_aa:
        args += ["-c"]

    # alignment mode (weight global: seeding/most outputs live there)
    m = int(rng.choice([0, 0, 0, 1, 2]))
    if m:
        args += ["-m", str(m)]
        descr.append(f"m={m}")
    if m == 2 and rng.random() < 0.5:
        args += ["-z", str(int(rng.integers(20, 200)))]
    if m == 2 and rng.random() < 0.5:
        args += ["-e", str(int(rng.integers(0, 20)))]

    # scores: matrix file or -M/-X
    if rng.random() < 0.2:
        args += ["-t", str(REPO / ("BLOSUM62.mtx" if is_aa
                                   else "HOXD70.mtx"))]
    elif rng.random() < 0.3:
        args += ["-M", str(int(rng.integers(1, 6))),
                 "-X", str(int(rng.integers(1, 9)))]

    # gap model: convex / affine / linear
    gm = rng.choice(["convex", "affine", "linear", "default"])
    if gm == "affine":
        args += ["-O", f"{int(rng.integers(1, 9))},0",
                 "-E", str(int(rng.integers(1, 5)))]
    elif gm == "linear":
        args += ["-O", "0", "-E", str(int(rng.integers(1, 5)))]
    elif gm == "convex":
        o1 = int(rng.integers(1, 9))
        args += ["-O", f"{o1},{o1 + int(rng.integers(1, 30))}",
                 "-E", f"{int(rng.integers(2, 5))},1"]
    descr.append(gm)

    # banding
    b = int(rng.choice([-1, 0, 1, 5, 10]))
    if b != 10:
        args += ["-b", str(b)]
    if rng.random() < 0.4:
        args += ["-f", str(rng.choice([0.0, 0.05, 0.2]))]

    # multi-consensus
    d = int(rng.choice([1, 1, 1, 2, 2, 3]))
    if d > 1:
        args += ["-d", str(d)]
        if rng.random() < 0.5:
            args += ["-q", str(rng.choice([0.1, 0.25, 0.3]))]

    # output mode
    r = int(rng.integers(0, 6))
    if r:
        args += ["-r", str(r)]
    descr.append(f"r={r}")

    # amb_strand (nt only — rc of aa is meaningless upstream too)
    amb = (not is_aa) and rng.random() < 0.25
    if amb:
        args += ["-s"]

    # seeding (global mode only; small windows force the anchored path
    # on short reads — or reference defaults, which partition naturally
    # once reads exceed min_w 500)
    if m == 0 and rng.random() < 0.3:
        args += ["-S"]
        if rng.random() < 0.6:
            args += ["-k", str(int(rng.choice([3, 5, 7] if is_aa
                                              else [5, 9, 13, 19])))]
            args += ["-w", str(int(rng.choice([3, 5, 10])))]
            args += ["-n", str(int(rng.choice([10, 30, 100, 500])))]
        if rng.random() < 0.5:
            args += ["-p"]
        descr.append("S")

    # FASTQ + qv weights
    is_fastq = (not is_aa) and rng.random() < 0.3
    if is_fastq and rng.random() < 0.7:
        args += ["-Q"]
        descr.append("Q")

    # incremental restore (-i): a prior run's GFA or MSA output becomes
    # the starting graph (ref abpoa_restore_graph, abpoa_seq.c:595-660).
    # The incr file itself is generated by the REFERENCE on a first read
    # set, so both sides restore identical bytes. nt/global only (the
    # reference's own -i usage); seeding composes but keep cases simple.
    incr = None  # (first_fasta_text, gen_args) or None
    if (not is_aa) and m == 0 and "-S" not in args \
            and rng.random() < 0.15:
        n0 = int(rng.integers(2, 7))
        lines0 = []
        for i in range(n0):
            seq = _mutate(rng, anc, alpha, sub_p, ind_p)
            lines0.append(f">base{i}\n{seq}")
        fmt = "-r3" if rng.random() < 0.6 else "-r1"
        incr = ("\n".join(lines0) + "\n", [fmt])
        descr.append(f"i({fmt})")

    # haplotypes for the multi-allele path
    haps = [anc]
    if d > 1 and n_reads >= 4:
        haps.append(_mutate(rng, anc, alpha, 0.08, 0.02))

    lines = []
    for i in range(n_reads):
        hap = haps[int(rng.integers(len(haps)))]
        seq = _mutate(rng, hap, alpha, sub_p, ind_p)
        if amb and rng.random() < 0.4:
            seq = seq.translate(RC)[::-1]
        if (not is_aa) and rng.random() < 0.05:
            # sprinkle ambiguity codes (encode to 4 on both sides)
            pos = rng.integers(0, len(seq), max(1, len(seq) // 50))
            sl = list(seq)
            for p in pos:
                sl[p] = "N"
            seq = "".join(sl)
        if is_fastq:
            qual = "".join(chr(33 + int(q))
                           for q in rng.integers(0, 41, len(seq)))
            lines.append(f"@read{i}\n{seq}\n+\n{qual}")
        else:
            lines.append(f">read{i}\n{seq}")
    return ("\n".join(lines) + "\n", is_fastq, args, " ".join(descr),
            incr)


# ------------------------------------------------------------------ #
def run_ref(inp: pathlib.Path, args: list[str]):
    """-> (rc, stdout_bytes, stderr_tail)"""
    env = dict(os.environ, CANARY_BYTE="0x00")
    r = subprocess.run([str(REF_BIN), *args, str(inp)],
                       capture_output=True, env=env, timeout=120)
    return r.returncode, r.stdout, r.stderr[-200:]


ENGINE = None  # set by --engine: our side runs e.g. --engine jax


def run_ours(inp: pathlib.Path, args: list[str], out: pathlib.Path):
    """-> (rc, out_bytes, stderr_tail). An exception out of cli.main is
    a nonzero exit for the failure-for-failure contract (the reference's
    analogs are err_fatal exits and SIGABRTs)."""
    from abpoa_tpu import cli
    if out.exists():
        out.unlink()
    eng = ["--engine", ENGINE] if ENGINE else []
    err = io.StringIO()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli.main([*args, *eng, "-o", str(out), str(inp)])
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed
        rc = 2
        err.write(f" EXC {e!r}")
    body = out.read_bytes() if out.exists() else b""
    return rc, body, err.getvalue()[-200:]


def gen_list_case(seed: int, workdir: pathlib.Path):
    """List-mode (-l) case: 4-7 independent single-instance files, one
    consensus each (ref serial loop abpoa.c:135-143; our --engine jax
    side batches all files through BatchPOA — the production device path,
    byte-identical by contract). Reuses gen_case inputs from derived
    seeds; flags come from the base seed but drop per-file modes."""
    rng = np.random.default_rng(10_000_019 + seed)
    k = int(rng.integers(4, 8))
    fns = []
    for i in range(k):
        text, is_fq, _, _, _ = gen_case(200_000 + seed * 8 + i)
        p = workdir / (f"li{i}.fq" if is_fq else f"li{i}.fa")
        p.write_text(text)
        fns.append(str(p))
    lst = workdir / "in.list"
    lst.write_text("\n".join(fns) + "\n")
    args = ["-l"]
    r = int(rng.integers(0, 6))
    if r:
        args += ["-r", str(r)]
    if rng.random() < 0.3:
        args += ["-d", "2"]
    if rng.random() < 0.3:
        args += ["-Q"]
    return lst, args, f"list k={k} r={r}"


def run_case(seed: int, workdir: pathlib.Path, list_mode: bool = False):
    """-> (ok, descr, ref_bytes, got_bytes, args, input_text)

    Parity contract: equal stdout bytes on success, and
    failure-for-failure — when the sanitized reference err_fatals
    (e.g. its backtrack dead-end, ref src/simd_abpoa_align.c:419), our
    CLI must also exit nonzero (the oracle reproduces the dead end)."""
    if list_mode:
        # reference side runs per file and concatenates: the reference's
        # own -l loop leaks stale FASTQ qualities into later FASTA files
        # under -Q (docs/REFERENCE_UB.md finding 3); per-file runs are
        # its defined semantics, which our list mode must match
        inp, args, descr = gen_list_case(seed, workdir)
        text, incr = inp.read_text(), None
        sargs = [x for x in args if x != "-l"]
        ref_rc, ref, ref_err = 0, b"", b""
        for fn in text.splitlines():
            rc1, out1, err1 = run_ref(pathlib.Path(fn), sargs)
            ref += out1
            if rc1 != 0:
                ref_rc, ref_err = rc1, err1
        got_rc, got, got_err = run_ours(inp, args, workdir / "ours.out")
        if ref_rc != 0:
            ok = got_rc != 0
            descr += f" [ref-fatal: {ref_err.strip()!r:.120}]"
        else:
            ok = got_rc == 0 and ref == got
        return ok, descr, ref, got, args, text
    else:
        text, is_fastq, args, descr, incr = gen_case(seed)
        inp = workdir / ("in.fq" if is_fastq else "in.fa")
        if seed % 17 == 3:
            # gzipped input (ref xzopen/kseq reads .gz transparently)
            import gzip
            inp = inp.with_suffix(inp.suffix + ".gz")
            with gzip.open(inp, "wt") as fp:
                fp.write(text)
            descr += " gz"
        else:
            inp.write_text(text)
    if incr is not None:
        base_text, gen_args = incr
        base_inp = workdir / "base.fa"
        base_inp.write_text(base_text)
        rc0, incr_bytes, err0 = run_ref(base_inp, gen_args)
        if rc0 != 0 or not incr_bytes.strip():
            return (True, descr + " [incr-gen-skip]", b"", b"", args,
                    text)
        incr_fn = workdir / "incr.in"
        incr_fn.write_bytes(incr_bytes)
        args = args + ["-i", str(incr_fn)]
    ref_rc, ref, ref_err = run_ref(inp, args)
    got_rc, got, got_err = run_ours(inp, args, workdir / "ours.out")
    if ref_rc != 0:
        ok = got_rc != 0
        descr += f" [ref-fatal: {ref_err.strip()!r:.120}]"
    else:
        ok = got_rc == 0 and ref == got
    return ok, descr, ref, got, args, text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--engine", choices=["numpy", "jax"], default=None,
                    help="route our side through this DP engine "
                         "(jax = the device path; on CPU this fuzzes "
                         "its XLA end)")
    ap.add_argument("--list-mode", action="store_true",
                    help="fuzz -l list cases (with --engine jax these "
                         "batch all files through BatchPOA, the "
                         "production device path)")
    a = ap.parse_args()
    if a.engine:
        global ENGINE
        ENGINE = a.engine
        if a.engine == "jax":
            from abpoa_tpu.jaxcache import enable_compile_cache
            enable_compile_cache()
    if not REF_BIN.exists():
        sys.exit("sanitized reference missing; run "
                 "tests/golden/make_sanitized_ref.sh first")
    # per-process workdir: concurrent campaigns must not clobber inputs
    work = (pathlib.Path(tempfile.gettempdir()) / "abpoa_fuzz"
            / f"work.{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    fails = []
    for seed in range(a.start, a.start + a.n):
        try:
            ok, descr, ref, got, args, text = run_case(
                seed, work, list_mode=a.list_mode)
        except Exception as e:
            ok, descr = False, f"EXC {e!r:.200}"
            ref = got = b""
            if a.list_mode:
                args, text = ["-l"], ""
            else:
                text, _, args, _, _ = gen_case(seed)  # keep the repro
        if ok:
            if not a.quiet:
                print(f"seed {seed:5d} OK   {descr}")
            continue
        fails.append(seed)
        rd = pathlib.Path(tempfile.gettempdir()) / "abpoa_fuzz" / str(seed)
        rd.mkdir(parents=True, exist_ok=True)
        (rd / "input").write_text(text)
        (rd / "args").write_text(" ".join(args) + "\n")
        (rd / "ref.out").write_bytes(ref)
        (rd / "got.out").write_bytes(got)
        print(f"seed {seed:5d} FAIL {descr}  args: {' '.join(args)}  "
              f"-> {rd}")
        if not a.keep_going:
            break
    print(f"\n{a.n} cases from seed {a.start}: "
          f"{a.n - len(fails)} ok, {len(fails)} failed"
          + (f" {fails}" if fails else ""))
    shutil.rmtree(work, ignore_errors=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
