"""K1's share of its roofline: its least possible time over its measured
device time in the traced window.

A launch of P pairs, each a query of L codes swept over `rows` rows against
a window of W codes, fills P * rows * W cells of the affine Smith-Waterman
matrix. Its least time is the larger of
- bytes / HBM bandwidth: the queries (P * L bytes), the windows (P * W) and
  the three int32 outputs (P * 12) read or written once each;
- cells * OPS_PER_CELL / the INT32 issue rate.

OPS_PER_CELL is a floor of the recurrence in packed 16-bit arithmetic, two
cells in one 32-bit instruction, whatever implements it. A pair of cells
needs at least: the gap-open term H - (go + ge), shared by the E of the next
column and the F of the next row (1); E = max(E_left - ge, open_left) as a
fused add-max (1); F likewise (1); the substitution score of the two
(q, w) codes (1); H = max(0, H_diag + s, E, F) as a fused add-max and a
three-way max with zero (2); the running best cell (1): 7 instructions for
2 cells, 3.5 a cell. This count is frozen here; the kernel's own count
does not enter it.
"""

from benchmark.harness.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S

OPS_PER_CELL = 3.5
KERNEL = "sw_score_kernel"


def least_seconds(pairs, L, W, rows):
    cells = pairs * rows * W
    nbytes = pairs * (L + W + 12)
    return max(nbytes / HBM_BYTES_PER_S, cells * OPS_PER_CELL / INT32_OPS_PER_S)


def read(rec):
    measured = rec["trace"].device_seconds(KERNEL)
    if not rec["k1_launches"] or measured <= 0:
        return None
    least = sum(least_seconds(*x) for x in rec["k1_launches"])
    return 100.0 * least / measured
