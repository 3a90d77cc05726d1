"""Bytes and FLOPs from shapes, against the kernel table's bounds at
B = 32768 on the 27q heavy-hex Clifford env and hand-worked shapes."""

import pytest

from portbench.metrics import costs


def test_b1_bytes_at_the_table_bound():
    nbytes = costs.b1_bytes(32768, 2, 54, 27)
    assert nbytes == 32768 * (886 + 882)
    assert nbytes / 1e6 == pytest.approx(58.0, abs=0.1)
    assert nbytes / costs.PEAK_HBM_BYTES * 1e6 == pytest.approx(17.30,
                                                                abs=0.02)


def test_b2_bytes_at_the_table_bound():
    assert costs.b2_bytes(32768, 27, True) / 1e6 == pytest.approx(16.4,
                                                                  abs=0.05)
    assert costs.b2_bytes(32768, 27, False) / 1e6 == pytest.approx(2.2,
                                                                   abs=0.05)


def test_policy_flops():
    # 2 * (2916*512 + 512*256 + 256*219 + 256*1)
    assert costs.policy_flops(2916, 512, [256], 219) == 3_360_768
    # 2 * (3186*512 + 512*256 + 256*303 + 256*1)
    assert costs.policy_flops(3186, 512, [256], 303) == 3_680_256
    assert costs.policy_flops(10, 4, [3], 2, [5], [], copies=2) == 2 * (
        2 * (10 * 4 + 4 * 3) + 2 * (3 * 5 + 5 * 2) + 2 * 3)


def test_shares():
    assert costs.roofline_share(3.35e12, 2.0) == pytest.approx(50.0)
    assert costs.mfu(67e12, 4.0) == pytest.approx(25.0)
