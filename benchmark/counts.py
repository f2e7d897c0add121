"""Operations and bytes that the measured work needs, fixed from the
algorithms and the sizes, never from the program's launches or recorded
programs; and the peak table they are held against (peaks.json).

Units: one 32-bit integer instruction (a 32 x 32 multiply-add), which
the card issues at `int32_ops_per_s`. A count is the least that a careful
implementation needs, so a share of its roofline stays below 100%.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(kind: str) -> Optional[dict]:
    """The card's peaks by its name, None for a card not in the table."""
    return PEAKS.get(kind)


# -- BLS12-381 pairing ------------------------------------------------------
# One Fq product: Montgomery multiplication of 12 32-bit words by CIOS,
# 2 s^2 + s = 300 multiply-adds (Koc, Acar, Kaliski 1996).
FQ_PRODUCT_OPS = 2 * 12 * 12 + 12
M2, S2 = 3, 2                 # Fq2 product (Karatsuba) and square (complex)
FQ12_MUL = 18 * M2            # Fq12 product, Karatsuba over Fq6 / Fq2
FQ12_SQR = 12 * M2            # Fq12 square, complex method over Fq6
CYCLO_SQR = 6 * S2            # compressed cyclotomic square (Karabina 2013)
SPARSE_LINE = 13 * M2         # f times a sparse line (Aranha et al. 2011)
DBL_STEP = 3 * M2 + 6 * S2 + 4        # doubling step and its line, projective
ADD_STEP = 11 * M2 + 2 * S2 + 4       # addition step and its line
Z = 0xD201000000010000        # |z|, the BLS parameter is -z


def _steps(e: int):
    """(squarings, multiplications) of a square-and-multiply by e."""
    return e.bit_length() - 1, bin(e).count("1") - 1


def pairing_fq_products(pairs: int) -> int:
    """Fq products of one group's product of `pairs` pairings: the shared
    Miller loop over |z| (63 doubling and 5 addition steps a pair, 62 Fq12
    squares a group: the first square is of 1) and one final
    exponentiation to the power 3 (q^12 - 1) / r: the easy part (two Fq12
    products; the Fq12 inversion and the Frobenius maps counted as no
    products) and the hard part (q^4 - q^2 + 1) * 3 / r as
    (z - 1)^2 (z + q) (z^2 + q^2 - 1) + 3: exponentiations by |z| + 1
    twice and by |z| three times in the cyclotomic subgroup, 8 further
    Fq12 products and one cyclotomic square."""
    dbl, add = _steps(Z)
    miller = (dbl - 1) * FQ12_SQR + pairs * (dbl * (DBL_STEP + SPARSE_LINE)
                                              + add * (ADD_STEP + SPARSE_LINE))
    sq1, mul1 = _steps(Z + 1)
    sq0, mul0 = _steps(Z)
    hard = (2 * sq1 + 3 * sq0 + 1) * CYCLO_SQR + (2 * mul1 + 3 * mul0 + 8) * FQ12_MUL
    return miller + 2 * FQ12_MUL + hard


def pairing_ops(groups: int, pairs: int) -> int:
    return groups * pairing_fq_products(pairs) * FQ_PRODUCT_OPS
