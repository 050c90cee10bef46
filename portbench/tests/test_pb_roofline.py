"""The roofline arithmetic against hand counts (PERF.md's kernel
table), through the resident cohort's table of products."""

from __future__ import annotations

import pytest

from portbench import manifest, roofline

N, P = 501_760, 100_352
TABLE = manifest.cohort("resident_packed").products


def work(method, kc, in_rows, out_rows):
    _, products, dots, halves, _, _ = TABLE[method]
    return roofline.product_work(N, P, kc, products, dots, halves,
                                 in_rows, out_rows)


def test_b1_wide_kc16_bound_is_ops():
    flops, nbytes = work("crossprod", 16, N, P)
    assert flops == 2 * 16 * N * P
    t, which = roofline.least_seconds(flops, nbytes)
    assert which == "ops"
    assert t * 1e3 == pytest.approx(24.05, abs=0.005)


def test_scca_one_column_bound_is_bytes():
    flops, nbytes = work("_cross_p", 1, N, P)
    t, which = roofline.least_seconds(flops, nbytes)
    assert which == "bytes"
    assert t * 1e3 == pytest.approx(3.76, abs=0.005)


def test_packed_bytes():
    assert roofline.packed_bytes(N, P) == P * N // 4
    assert roofline.packed_bytes(5, 3) == 6


def test_grams_count_both_products():
    one = work("prod", 24, P, N)
    gram = work("gram_permuted", 24, N, N)
    assert gram[0] == 2 * one[0]
    ff = work("gram_ff_permuted", 24, N, N)
    # B3 two dots + B4 three: 108.22 + 72.15 ms at kc 24
    assert roofline.least_seconds(*ff)[0] * 1e3 == pytest.approx(
        72.15 + 108.22, abs=0.02)


def test_width_is_the_callers():
    a = work("crossprod", 1, N, P)[0]
    b = work("crossprod", 8, N, P)[0]
    assert b == 8 * a


def test_groups_the_readers_name():
    assert {g for g, *_ in TABLE.values()} == {"plain", "ff", "narrow"}
