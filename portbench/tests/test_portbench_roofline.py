"""The frozen byte counts and the roofline share."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_fusion_bytes_of_the_3d_grid():
    # 256 tiles of 100^3 uint16 read once, a (101, 1306, 1306) uint16 output written once
    assert roofline.fusion_bytes(256, (100, 100, 100), (101, 1306, 1306)) == (
        256 * 1000000 * 2 + 101 * 1306 * 1306 * 2)


def test_fusion_bytes_of_the_two_channel_grid():
    assert roofline.fusion_bytes(256, (100, 100), (1306, 1306), channels=2) == (
        2 * (256 * 10000 * 2 + 1306 * 1306 * 2))


def test_share_pct():
    # 3.35 GB in 1 ms is the bound itself; in 10 ms a tenth of it
    assert roofline.share_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 1e-2) == pytest.approx(10.0)
    assert roofline.share_pct(1.0, 0.0) is None
