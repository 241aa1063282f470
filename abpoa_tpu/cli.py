"""Command-line interface — flag-compatible with the abpoa binary.

reference: /root/reference/src/abpoa.c:22-220.
"""
from __future__ import annotations

import sys
import time

from .api import ABPOA
from .params import (Params, GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE,
                     OUT_CONS, OUT_MSA, OUT_CONS_MSA, OUT_GFA, OUT_CONS_GFA,
                     OUT_CONS_FQ)

USAGE = """\
abpoa-tpu: adaptive banded Partial Order Alignment (JAX device engine)

Usage: abpoa-tpu [options] <in.fa/fq> > cons.fa/msa.out/abpoa.gfa

Options:
  Alignment:
    -m --aln-mode   INT     alignment mode [0]: 0 global, 1 local, 2 extension
    -M --match      INT     match score [2]
    -X --mismatch   INT     mismatch penalty [4]
    -t --matrix    FILE     scoring matrix file (e.g. HOXD70.mtx, BLOSUM62.mtx)
    -O --gap-open INT(,INT) gap opening penalty (O1,O2) [4,24]
    -E --gap-ext  INT(,INT) gap extension penalty (E1,E2) [2,1]
    -s --amb-strand         ambiguous strand mode [False]
  Adaptive banded DP:
    -b --extra-b    INT     first adaptive banding parameter [10]
    -f --extra-f  FLOAT     second adaptive banding parameter [0.01]
  Minimizer-based seeding and partition (global mode only):
    -S --seeding            enable minimizer-based seeding and anchoring
    -k --k-mer       INT    minimizer k-mer size [19]
    -w --window      INT    minimizer window size [10]
    -n --min-poa-win INT    min. size of window to perform POA [500]
    -p --progressive        build guide tree, progressive POA
  Input/Output:
    -Q --use-qual-weight    FASTQ quality as edge weight [False]
    -c --amino-acid         amino-acid input [False]
    -l --in-list            input is a list of sequence files
    -i --incrmnt    FILE    incrementally align onto existing graph/MSA
    -o --output     FILE    output to FILE [stdout]
    -r --result      INT    0 cons FASTA / 1 MSA / 2 both / 3 GFA /
                            4 GFA+cons / 5 cons FASTQ [0]
    -d --maxnum-cons INT    max number of consensus sequences [1]
    -q --min-freq  FLOAT    min frequency of each consensus [0.25]
    -g --out-pog    FILE    dump final graph to FILE (.pdf/.png)
    -h --help               this message
    -v --version            version
"""

LONG_OPTS = {
    "--aln-mode": "m", "--match": "M", "--mismatch": "X", "--matrix": "t",
    "--gap-open": "O", "--gap-ext": "E", "--extra-b": "b", "--extra-f": "f",
    "--zdrop": "z", "--bonus": "e", "--seeding": "S", "--k-mer": "k",
    "--window": "w", "--min-poa-win": "n", "--progressive": "p",
    "--use-qual-weight": "Q", "--amino-acid": "c", "--in-list": "l",
    "--increment": "i", "--incrmnt": "i", "--amb-strand": "s",
    "--output": "o", "--result": "r", "--out-pog": "g",
    "--max-num-cons": "d", "--maxnum-cons": "d", "--min-freq": "q",
    "--help": "h", "--version": "v", "--engine": "\x01",
}
TAKES_ARG = set("mMXtOEbfzekwnioqrgdqV\x01")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    params = Params()
    in_list = False
    out = sys.stdout
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key = a.split("=")[0]
            if key not in LONG_OPTS:
                print(f"Error: unknown option: {a}.", file=sys.stderr)
                print(USAGE, file=sys.stderr)
                return 1
            c = LONG_OPTS[key]
            if c in TAKES_ARG:
                if "=" in a:
                    arg = a.split("=", 1)[1]
                else:
                    i += 1
                    arg = argv[i]
            else:
                arg = None
        elif a.startswith("-") and len(a) >= 2 and a != "-":
            c = a[1]
            if c in TAKES_ARG:
                if len(a) > 2:
                    arg = a[2:]
                else:
                    i += 1
                    arg = argv[i]
            else:
                arg = None
        else:
            pos.append(a)
            i += 1
            continue
        i += 1
        if c == "m":
            m = int(arg)
            if m not in (GLOBAL_MODE, LOCAL_MODE, EXTEND_MODE):
                print(f"Unknown alignment mode: {m}.", file=sys.stderr)
                return 1
            params.align_mode = m
        elif c == "M":
            params.match = int(arg)
        elif c == "X":
            params.mismatch = int(arg)
        elif c == "t":
            params.use_score_matrix = True
            params.mat_fn = arg
        elif c == "O":
            parts = arg.split(",")
            params.gap_open1 = int(parts[0])
            if len(parts) > 1:
                params.gap_open2 = int(parts[1])
        elif c == "E":
            parts = arg.split(",")
            params.gap_ext1 = int(parts[0])
            if len(parts) > 1:
                params.gap_ext2 = int(parts[1])
        elif c == "b":
            params.wb = int(arg)
        elif c == "f":
            params.wf = float(arg)
        elif c == "z":
            params.zdrop = int(arg)
        elif c == "e":
            params.end_bonus = int(arg)
        elif c == "Q":
            params.use_qv = True
        elif c == "S":
            params.disable_seeding = False
        elif c == "k":
            params.k = int(arg)
        elif c == "w":
            params.w = int(arg)
        elif c == "n":
            params.min_w = int(arg)
        elif c == "c":
            params.m = 27
        elif c == "i":
            params.incr_fn = arg
        elif c == "l":
            in_list = True
        elif c == "p":
            params.progressive_poa = True
        elif c == "s":
            params.amb_strand = True
        elif c == "o":
            if arg != "-":
                out = open(arg, "w")
        elif c == "r":
            r = int(arg)
            if r == OUT_CONS:
                params.out_cons, params.out_msa = True, False
            elif r == OUT_MSA:
                params.out_cons, params.out_msa = False, True
            elif r == OUT_CONS_MSA:
                params.out_cons = params.out_msa = True
            elif r == OUT_GFA:
                params.out_cons, params.out_gfa = False, True
            elif r == OUT_CONS_GFA:
                params.out_cons, params.out_gfa = True, True
            elif r == OUT_CONS_FQ:
                params.out_cons, params.out_fq = True, True
            else:
                print(f"Error: unknown output result mode: {arg}.",
                      file=sys.stderr)
        elif c == "g":
            params.out_pog = arg
        elif c == "d":
            params.max_n_cons = int(arg)
        elif c == "q":
            params.min_freq = float(arg)
        elif c == "V":
            params.verbose = int(arg)
        elif c == "\x01":  # --engine {numpy,jax}: DP engine selection
            if arg not in ("numpy", "jax", "auto"):
                print(f"Error: unknown engine: {arg} "
                      f"(expected numpy|jax).", file=sys.stderr)
                return 1
            params.engine = arg
        elif c == "h":
            print(USAGE, file=sys.stderr)
            return 1
        elif c == "v":
            from . import __version__
            print(__version__)
            return 0
    if len(pos) != 1:
        print(USAGE, file=sys.stderr)
        return 1
    params.post_set()
    if params.engine == "jax":
        from .jaxcache import enable_compile_cache
        enable_compile_cache()
    t0 = time.time()
    try:
        _run(params, in_list, pos, out)
    except (RuntimeError, IndexError) as e:
        # fatal-path parity: the reference err_fatals/aborts to stderr
        # and exits nonzero on invariant violations — backtrack dead
        # ends (ref src/simd_abpoa_align.c:419, src/utils.c:91-123) and
        # chaining allocator aborts on pathological rc'd seeded reads
        # (kalloc 'N: <0 Abort!', observed at fuzz seed 7887 where the
        # reference exits SIGABRT in abpoa_dp_chaining)
        print(f"[abpoa_tpu] {type(e).__name__}: {e}", file=sys.stderr)
        if out is not sys.stdout:
            out.close()
        return 1
    # end-of-run telemetry line (ref src/abpoa.c:146, src/utils.c:339-371)
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = ru.ru_utime + ru.ru_stime
        rss_gb = ru.ru_maxrss / (1024.0 * 1024.0)
        print(f"[abpoa_tpu] Real time: {time.time()-t0:.3f} sec; "
              f"CPU: {cpu:.3f} sec; Peak RSS: {rss_gb:.3f} GB.",
              file=sys.stderr)
    except Exception:
        print(f"[abpoa_tpu] Real time: {time.time()-t0:.3f} sec.",
              file=sys.stderr)
    if out is not sys.stdout:
        out.close()
    return 0


def _run(params, in_list, pos, out):
    ab = ABPOA()
    if in_list:
        with open(pos[0]) as fp:
            fns = [line.strip() for line in fp if line.strip()]
        # device list mode: batch one POA instance per file across the
        # device (the reference runs list entries serially); qv weights and
        # incremental -i instances batch too (ref abpoa.c:135-143)
        if params.engine == "jax" and len(fns) >= 4:
            from .parallel.batch import batch_msa_from_files
            batch_msa_from_files(params, fns, out)
        else:
            for fn in fns:
                ab.msa_from_file(params, fn, out=out)
    else:
        ab.msa_from_file(params, pos[0], out=out)


if __name__ == "__main__":
    sys.exit(main())
