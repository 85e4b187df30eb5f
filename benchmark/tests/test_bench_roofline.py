"""The roofline counts against values worked out by hand from the
formulas' terms at the production shapes."""

import pytest

from benchmark import roofline

MPC = {"N": 20, "qp_iters": 150, "sqp_iters": 6, "warm_qp_iters": 40}


def test_k1_counts():
    # a game: 47 floats in (x 20, controls 8, score 2, time 1, damage 16)
    # and 39 out; the populate's table 20 x 51 x 6 floats
    assert roofline.k1_bytes(1, 50) == 4 * (86 + 6120)
    assert roofline.k1_bytes(32768, 50) == 4 * (32768 * 86 + 6120)
    assert roofline.k1_flops(32768, 50) == 11 * 20 * 51 * 32768
    # 32,768 games: 367.7 MFLOP at 67 TFLOP/s (5.49 us) over 11.3 MB at
    # 3.35 TB/s (3.37 us): bound by the operations
    assert roofline.k1_bound_s(32768, 50) == pytest.approx(
        11 * 20 * 51 * 32768 / 67e12)


def test_k3_count_by_hand():
    n1, m, M, N = 40, 100, 3, 20
    tri = 820
    gram = 6 * 20 * 40                                  # 4,800
    relin = 4 * 20 * 40 + 2 * 20 + 25 * 3 * 20          # 4,740
    warm = 5 * 3 * 20 + 2 * 20                          # 340
    seg = (400 + 4800 + 4 * 20 * tri + 2 * tri + 40 + 42666 + 3200 + 3200
           + 600 + 700)                                 # 122,846
    it = 6400 + 3280 + 1900 + 600                       # 12,180
    want = gram + 6 * relin + 5 * warm + 9 * seg + (4 * 37 + 5 * 40) * it
    assert want == 5379194
    assert roofline.k3_flops(n1, m, M, N, 4, 37, 5, 40) == want
    # PERF.md's bound of a K3 launch at P = 8,192: 0.6577 ms (operations)
    assert roofline.k3_bound_s(8192, MPC) * 1e3 == pytest.approx(0.6577,
                                                                 abs=1e-4)


def test_k4_count_and_bound():
    assert roofline.k4_flops(40, 80, 20, 2, 20, 4, 37, 5, 40) == 14603957
    # PERF.md's bound of a K4 launch at P = 4,096: 0.8928 ms (operations)
    assert roofline.k4_bound_s(4096, MPC) * 1e3 == pytest.approx(0.8928,
                                                                 abs=1e-4)


def test_k3_k4_bytes():
    # K3: H 1600, g 40, sg 1600, p0 40, obs 6, arena 80, box and start
    # 120 in; x 40 and 5 statistics out
    assert roofline.k3_bytes(1, 20, 3) == 4 * (3486 + 45)
    # K4: both blocks 3200, g 80, sg 3200, p0 80, obs 4, arena 160, box
    # and start 240 in; x 80 and 5 statistics out
    assert roofline.k4_bytes(1, 20, 2) == 4 * (6964 + 85)


def test_schedule_from_configuration():
    assert roofline.sqp_counts(MPC) == {"n_seg0": 4, "it0": 37,
                                        "sqp_rest": 5, "it_rest": 40}
