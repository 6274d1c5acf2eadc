import pytest

from gprfbench import work


def test_kernel_work_by_hand():
    # K1 on one 16 x 16 matrix: 2 m^3/3 FLOPs; the lower triangle in, L and W out
    assert work.kernel_work("chol_inv", 1, 16) == (2 * 16**3 / 3, 136 * 4 + 2 * 256 * 4)
    # K2 on two matrices, dy = 2: m^3/3 + m^2 dy + 2 m dy each; K, Y, n_active in; L, ll out
    f, b = work.kernel_work("mvn_ll", 2, 4, 2)
    assert f == 2 * (64 / 3 + 32 + 16)
    assert b == 2 * (10 * 4 + (8 + 1) * 4) + 2 * (16 + 1) * 4
    assert work.kernel_work("tri_inv", 3, 8) == (3 * 512 / 3, 3 * 36 * 4 + 3 * 64 * 4)


def test_bound_takes_the_larger_of_operations_and_bytes():
    flops, nbytes = work.kernel_work("chol_inv", 100, 136)
    assert work.kernel_bound_s("chol_inv", 100, 136) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))
    assert work.kernel_bound_s("chol_inv", 100, 136) == pytest.approx(nbytes / 3.35e12)


def test_eval_flops_reduce_to_the_padded_model_at_equal_sizes():
    m, dy, dx = 136, 50, 2
    assert work.pair_flops(m, m, dy, dx) == pytest.approx(
        10 / 3 * m**3 + 3 * m * m * dy + 2 * m * m * dx)
    got = work.eval_flops([m] * 3, [(1, 0), (2, 1)], dy, dx)
    want = 3 * (3 * (m**3 / 3 + m * m * dy + 2 * m * m * dx)
                + 2 * (10 / 3 * m**3 + 3 * m * m * dy + 2 * m * m * dx))
    assert got == pytest.approx(want)
    assert work.pair_flops(2, 3, 1, 1) == 4 * 3 + 2 * 2 * 9 + 9 + 2 * 6 + 9 + 2 * 6


def test_roofline_share():
    calls = [("chol_inv", 100, 136, 0)] * 4 + [("mvn_ll", 342, 136, 50)]
    events = [("void chol_inv_kernel(float const*)", 5.5e-5)] * 4
    share = work.roofline_share("K1", calls, events)
    assert share == pytest.approx(100 * work.kernel_bound_s("chol_inv", 100, 136) / 5.5e-5)
    assert work.roofline_share("K3", calls, events) is None
