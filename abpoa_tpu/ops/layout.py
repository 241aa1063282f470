"""Kernel-agnostic layouts shared by the device DP ends and the host.

Per-instance scalar vector (``S_*``) fed to the banded DP kernel, the
``misc`` result row (``M_*``) both device ends return beside the packed
backtrack step stream, and the backtrack operator bitmask (``BT_*``, ref
include/abpoa_align.h:20-27).

A backtrack step is one int32: ``op | row << 2 | col << 14`` with op 0 = M,
1 = I, 2 = D; rows need at most 12 bits (R <= 4096) and columns at most 18.
"""
from __future__ import annotations

NEG = -(1 << 29)

# scalar vector layout (per instance); the m*m score matrix follows S_NSCAL
(S_QLEN, S_NROWS, S_W, S_INF, S_REMEND, S_E1, S_O1, S_OE1, S_E2, S_O2,
 S_OE2, S_ZDROP, S_DPSN, S_NSCAL) = range(14)

# misc result row
(M_BEST, M_BI, M_BJ, M_CELLS, M_OVFL, M_NSTEPS, M_FAIL, M_ENDI, M_ENDJ,
 M_NMISC) = range(10)

# backtrack operator bitmask
BT_M, BT_E1, BT_E2, BT_F1, BT_F2 = 0x1, 0x2, 0x4, 0x8, 0x10
BT_E, BT_F, BT_ALL = 0x6, 0x18, 0x1F

# packed-step capacity: 12 row bits, 17 usable column bits
MAX_ROWS = 4096
MAX_COLS = 1 << 17
