"""The algorithm-fixed operation counts (benchmark/counts.py) and the
table of peaks."""
from benchmark import counts


def test_bls_parameter_bits():
    assert counts._steps(counts.Z) == (63, 5)          # |z| has Hamming weight 6
    assert counts._steps(counts.Z + 1) == (63, 6)


def test_pairing_products_by_hand():
    # Miller: 62 Fq12 squares (36 products) a group; per pair 63 doubling
    # steps (25 + 39) and 5 addition steps (41 + 39)
    miller = 62 * 36 + (63 * 64 + 5 * 80)
    # final exponentiation: easy part 2 x 54, hard part 316 cyclotomic
    # squares (12) and 35 Fq12 products (54)
    final = 108 + 316 * 12 + 35 * 54
    assert counts.pairing_fq_products(1) == miller + final == 12454
    assert counts.pairing_fq_products(2) - counts.pairing_fq_products(1) == 63 * 64 + 5 * 80
    assert counts.FQ_PRODUCT_OPS == 300
    assert counts.pairing_ops(128, 2) == 128 * 16886 * 300


def test_peaks_by_card_name():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert peak["int32_ops_per_s"] == 132 * 64 * 1.98e9
    assert counts.peaks("some other card") is None
