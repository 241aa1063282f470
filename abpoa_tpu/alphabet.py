"""Alphabet encode/decode tables.

Re-design of abPOA's base<->code tables
(reference: /root/reference/src/abpoa_seq.c:15-98). Sequences are encoded to
small integer codes once on the host and live as int8/int32 device arrays from
then on; decode tables are only used at the output boundary.

nt:  A/a->0 C/c->1 G/g->2 T/t/U/u->3 else->4 ('N'); code m-1 (=4) is the gap /
     wildcard row of the score matrix.
aa:  27-letter alphabet (codes 0..26), see ab_aa26_table.
"""
import numpy as np

# --- nucleotide tables (ref abpoa_seq.c:15-52) ---
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
# note ref maps raw bytes 0..3 to 0..3 as well (already-encoded input)
for _i in range(4):
    NT4_TABLE[_i] = _i
for _c, _v in (("A", 0), ("a", 0), ("C", 1), ("c", 1), ("G", 2), ("g", 2),
               ("T", 3), ("t", 3), ("U", 3), ("u", 3)):
    NT4_TABLE[ord(_c)] = _v

NT256_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _i, _c in enumerate("ACGTN-"):
    NT256_TABLE[_i] = ord(_c)
NT256_TABLE[27] = ord("-")
for _c in "ACGT":
    NT256_TABLE[ord(_c)] = ord(_c)
    NT256_TABLE[ord(_c.lower())] = ord(_c)
NT256_TABLE[ord("U")] = ord("T"); NT256_TABLE[ord("u")] = ord("T")

# --- amino-acid tables (ref abpoa_seq.c:57-95) ---
AA26_TABLE = np.full(256, 26, dtype=np.uint8)
for _i in range(27):
    AA26_TABLE[_i] = _i
# per ref: A->0 B->5 C->1 D->6 E->7 F->8 G->2 H->9 I->10 J->11 K->12 L->13
#          M->14 N->4 O->15 P->16 Q->17 R->18 S->19 T->3 U->20 V->21 W->22
#          X->23 Y->24 Z->25
_AA_MAP = {"A": 0, "B": 5, "C": 1, "D": 6, "E": 7, "F": 8, "G": 2, "H": 9,
           "I": 10, "J": 11, "K": 12, "L": 13, "M": 14, "N": 4, "O": 15,
           "P": 16, "Q": 17, "R": 18, "S": 19, "T": 3, "U": 20, "V": 21,
           "W": 22, "X": 23, "Y": 24, "Z": 25}
for _c, _v in _AA_MAP.items():
    AA26_TABLE[ord(_c)] = _v
    AA26_TABLE[ord(_c.lower())] = _v

AA256_TABLE = np.full(256, ord("*"), dtype=np.uint8)
_AA256 = "ACGTNBDEFHIJKLMOPQRSUVWXYZ*-"
for _i, _c in enumerate(_AA256):
    AA256_TABLE[_i] = ord(_c)
for _c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
    AA256_TABLE[ord(_c)] = ord(_c)
    AA256_TABLE[ord(_c.lower())] = ord(_c)


def encode_table(m: int) -> np.ndarray:
    """char->code table for an alphabet of m residue types (5=nt, 27=aa)."""
    return AA26_TABLE if m > 5 else NT4_TABLE


def decode_table(m: int) -> np.ndarray:
    return AA256_TABLE if m > 5 else NT256_TABLE


def encode_seq(seq: str | bytes, m: int = 5) -> np.ndarray:
    """Encode an ASCII sequence to codes (uint8)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return encode_table(m)[raw]


def decode_seq(codes, m: int = 5) -> str:
    codes = np.asarray(codes, dtype=np.int64)
    return decode_table(m)[codes].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of nt codes (4/N maps to 4), ref abpoa_align.c:316-319."""
    rc = codes[::-1].copy()
    mask = rc < 4
    rc[mask] = 3 - rc[mask]
    rc[~mask] = 4
    return rc
